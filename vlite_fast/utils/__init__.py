from vlite_fast.utils import vdif, sigproc  # noqa: F401
