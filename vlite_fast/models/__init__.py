from vlite_fast.models import baseband_dsp, synthesis, search, coadd  # noqa: F401
