"""Output re-quantization: channel trim + 2/4/8-bit digitize + byte packing.

Ref: sel_and_dig_2b/4b/8b (src/pb_kernels.cu:633-735).  Thresholds for the
2-bit path are optimized for chi^2_16-distributed powers with uniform output
levels; 4/8-bit use Jenet & Anderson 1998 Table 3 scalings.

Packing layout matches the reference byte-for-byte: within one byte, earlier
samples occupy lower bits (sample j -> bits [2j] for 2-bit, low nibble first
for 4-bit); byte order is time-major, then pol, then channel
(fastest-varying).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from vlite_fast import constants as C

# One packed byte whose every sample slot holds the quantizer's
# near-zero level — the pad fill for ragged search gulps (2-bit level 1
# = -0.098 sigma; 4-bit level 7; 8-bit level 127).  Shared by the host
# (models/search.search_gulp_packed) and device
# (runtime/pipeline.DeviceGulpStream.window) padding paths.
NEAR_ZERO_FILL = {2: 0x55, 4: 0x77, 8: 0x7F}


def quantize_2bit(x: jax.Array) -> jax.Array:
    """float -> uint8 levels {0,1,2,3} (ref src/pb_kernels.cu:654-666)."""
    t0, t1, t2 = C.QUANT2_THRESH
    lev = ((x >= t0).astype(jnp.uint8)
           + (x >= t1).astype(jnp.uint8)
           + (x >= t2).astype(jnp.uint8))
    return lev


def quantize_4bit(x: jax.Array) -> jax.Array:
    """float -> uint8 levels {0..15} (ref src/pb_kernels.cu:690-707):
    clip(floor(x/0.3188 + 7.5), 0, 15)."""
    tmp = x * jnp.float32(1.0 / C.QUANT4_SCALE) + C.QUANT4_OFFSET
    return jnp.clip(tmp, 0.0, 15.0).astype(jnp.uint8)


def quantize_8bit(x: jax.Array) -> jax.Array:
    """float -> uint8 (ref src/pb_kernels.cu:711-735):
    clip(floor(x/0.02957 + 127.5), 0, 255)."""
    tmp = x * jnp.float32(1.0 / C.QUANT8_SCALE) + C.QUANT8_OFFSET
    return jnp.clip(tmp, 0.0, 255.0).astype(jnp.uint8)


def pack_bits(levels: jax.Array, nbit: int) -> jax.Array:
    """Pack uint8 levels along the last axis, LSB-first.

    levels: (..., n) with n divisible by 8//nbit -> (..., n*nbit//8) uint8.
    """
    if nbit == 8:
        return levels
    per_byte = 8 // nbit
    shape = levels.shape[:-1] + (levels.shape[-1] // per_byte, per_byte)
    g = levels.reshape(shape).astype(jnp.uint32)
    shifts = (jnp.arange(per_byte, dtype=jnp.uint32) * nbit)
    return jnp.sum(g << shifts, axis=-1).astype(jnp.uint8)


def unpack_bits(packed: jax.Array, nbit: int) -> jax.Array:
    """Inverse of pack_bits (for tests/readers)."""
    if nbit == 8:
        return packed
    per_byte = 8 // nbit
    shifts = jnp.arange(per_byte, dtype=jnp.uint8) * nbit
    mask = jnp.uint8((1 << nbit) - 1)
    out = (packed[..., None] >> shifts) & mask
    return out.reshape(packed.shape[:-1] + (packed.shape[-1] * per_byte,))


_LEVEL2_CENTROIDS = (-1.24, -0.098, 0.85, 1.94)  # unit-normal bin centroids


def dequantize(packed: jax.Array, nbit: int) -> jax.Array:
    """Packed filterbank bytes -> float32 values recentered to ~N(0,1).

    The in-graph inverse used by the search stage (heimdall likewise reads
    the quantized sigproc stream).  packed: (..., nbytes) ->
    (..., nbytes * 8//nbit)."""
    lev = unpack_bits(packed, nbit)
    if nbit == 2:
        cent = jnp.asarray(_LEVEL2_CENTROIDS, jnp.float32)
        return cent[lev.astype(jnp.int32)]
    lev = lev.astype(jnp.float32)
    if nbit == 4:
        return (lev - C.QUANT4_OFFSET) * jnp.float32(C.QUANT4_SCALE)
    return (lev - C.QUANT8_OFFSET) * jnp.float32(C.QUANT8_SCALE)


def sel_and_dig(x: jax.Array, chanmin: int, chanmax: int,
                nbit: int) -> jax.Array:
    """Channel trim + quantize + pack (ref src/pb_kernels.cu:633-735).

    x: (npol, ntime, nchan) normalized filterbank -> packed uint8 of shape
    (ntime, npol * nchanout * nbit // 8), time-major with pol then channel
    fastest, matching the reference's flat output-byte indexing.
    """
    trimmed = x[:, :, chanmin:chanmax + 1]          # (npol, ntime, nchanout)
    if nbit == 2:
        lev = quantize_2bit(trimmed)
    elif nbit == 4:
        lev = quantize_4bit(trimmed)
    elif nbit == 8:
        lev = quantize_8bit(trimmed)
    else:
        raise ValueError(f"unsupported nbit {nbit}")
    npol, ntime, nchanout = lev.shape
    lev = jnp.swapaxes(lev, 0, 1).reshape(ntime, npol * nchanout)
    return pack_bits(lev, nbit)
