import numpy as np
import pytest

from vlite_fast import constants as C
from vlite_fast.utils import vdif


def test_header_roundtrip():
    h = vdif.VDIFHeader(seconds=123456, frame=25599, ref_epoch=40,
                        thread_id=1, station_id=7, bits_per_sample=8)
    h2 = vdif.VDIFHeader.parse(h.pack())
    assert h2 == h


def test_pack_parse_vectorized():
    n = 1000
    secs = np.repeat(np.arange(10), 100)
    frames = np.tile(np.arange(100), 10)
    threads = np.tile([0, 1], 500)
    raw = vdif.pack_headers(secs, frames, ref_epoch=40, thread_ids=threads,
                            station_id=3)
    f = vdif.parse_headers(raw)
    np.testing.assert_array_equal(f["seconds"], secs)
    np.testing.assert_array_equal(f["frame"], frames)
    np.testing.assert_array_equal(f["thread_id"], threads)
    assert (f["ref_epoch"] == 40).all()
    assert (f["station_id"] == 3).all()
    assert (f["frame_bytes"] == C.VDIF_FRAME_BYTES).all()


def test_frame_arithmetic():
    # contiguous frames differ by 1 (ref writer.c:310-342 convention)
    h = vdif.VDIFHeader(seconds=5, frame=0, thread_id=0)
    h2 = vdif.increment_header(h)
    assert vdif.frame_difference(h, h2) == 1
    assert h2.thread_id == 1 and h2.frame == 0
    h3 = vdif.increment_header(h2)
    assert (h3.thread_id, h3.frame) == (0, 1)
    # second rollover
    hl = vdif.VDIFHeader(seconds=5, frame=C.FRAMES_PER_SEC - 1, thread_id=1)
    hn = vdif.increment_header(hl)
    assert (hn.seconds, hn.frame, hn.thread_id) == (6, 0, 0)


def test_streams_frames_roundtrip():
    rng = np.random.default_rng(0)
    nsamp = C.VDIF_DATA_BYTES * 6
    samples = rng.integers(0, 256, (2, nsamp), dtype=np.uint8)
    stream = vdif.streams_to_frames(samples, ref_epoch=40,
                                    start_second=100, station_id=9)
    back, hdr = vdif.frames_to_streams(stream)
    np.testing.assert_array_equal(back, samples)
    assert hdr.seconds == 100 and hdr.station_id == 9


def test_unix_time():
    # epoch 40 = 2020-01-01
    h = vdif.VDIFHeader(seconds=0, frame=0, ref_epoch=40)
    import calendar
    assert h.unix_time == calendar.timegm((2020, 1, 1, 0, 0, 0))


def test_placed_decoding_bounds_corrupt_span():
    """ADVICE r2: a corrupt header's garbage seconds field must raise a
    continuity error, not size the output buffer to terabytes."""
    import numpy as np
    import pytest
    from vlite_fast import constants as C
    from vlite_fast.utils import vdif
    rate = 50_000
    samples = np.random.default_rng(2).integers(
        1, 255, (2, rate), dtype=np.uint8)
    stream = vdif.streams_to_frames(samples, ref_epoch=40,
                                    start_second=100, sample_rate=rate)
    frames = stream.reshape(-1, C.VDIF_FRAME_BYTES).copy()
    # corrupt one header: absurd seconds value
    bad_hdr = vdif.pack_headers(np.array([10_000_000]), np.array([0]),
                                40, np.array([0]), 0)
    frames[3, :C.VDIF_HEADER_BYTES] = bad_hdr[0]
    with pytest.raises(ValueError, match="corrupt header"):
        vdif.frames_to_streams_placed(frames.reshape(-1), rate)
    # sane streams still decode
    out, start = vdif.frames_to_streams_placed(stream, rate)
    np.testing.assert_array_equal(out, samples)
