from vlite_fast.ops import (  # noqa: F401
    unpack,
    kurtosis,
    normalize,
    channelize,
    quantize,
    injection,
    coherent,
    dedisperse,
)
