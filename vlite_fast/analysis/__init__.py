from vlite_fast.analysis import baseband, localization  # noqa: F401
