"""Coincidencer/trigger plane tests (ref src/trigger.py, candidate.py)."""

import numpy as np
import pytest

from vlite_fast.config import TriggerConfig
from vlite_fast.ops.dedisperse import Candidate
from vlite_fast.runtime import trigger as trig

TSAMP = 1.0 / 1280


def cand(sn=10.0, dm=80.0, i0=1000, i1=1010, tfilt=3, dmi=40):
    return Candidate(snr=sn, peak_idx=(i0 + i1) // 2,
                     peak_time=(i0 + i1) / 2 * TSAMP, tfilt=tfilt,
                     dmi=dmi, dm=dm, ngiant=1, i0=i0, i1=i1)


def test_overlap_rules():
    a = trig.BeamCandidate(cand(), 0, TSAMP)
    assert a.overlaps(trig.BeamCandidate(cand(i0=1005, i1=1015), 1, TSAMP))
    # DM mismatch
    assert not a.overlaps(trig.BeamCandidate(cand(dm=120.0), 1, TSAMP))
    # no time overlap
    assert not a.overlaps(trig.BeamCandidate(cand(i0=2000, i1=2010), 1, TSAMP))
    # width ratio too large
    assert not a.overlaps(
        trig.BeamCandidate(cand(i0=990, i1=1060), 1, TSAMP))


def test_coincidence_beam_mask():
    per_beam = {
        0: [cand()],
        1: [cand(i0=1002, i1=1012)],
        2: [cand(i0=5000, i1=5010)],   # unrelated
    }
    out = trig.coincidence(per_beam, TSAMP)
    by_beam = {bc.beam: bc for bc in out}
    # beam 0's candidate sees itself + beam 1
    assert (by_beam[0].beam_mask > 0).sum() == 2
    assert (by_beam[2].beam_mask > 0).sum() == 1


def test_coincidence_symmetric_across_slices():
    """A pair overlapping across a 1 s slice boundary must update BOTH
    masks: the earlier-ending candidate once failed min_beams because the
    later slice never reported back."""
    # slice is 1 s = 1280 samples; A ends in slice 0, B ends in slice 1
    a = cand(i0=1200, i1=1270)
    b = cand(i0=1250, i1=1300)
    out = trig.coincidence({0: [a], 1: [b]}, TSAMP)
    by_beam = {bc.beam: bc for bc in out}
    assert (by_beam[0].beam_mask > 0).sum() == 2   # sees itself + beam 1
    assert (by_beam[1].beam_mask > 0).sum() == 2


def test_trigger_cuts():
    cfg = TriggerConfig()
    per_beam = {
        0: [cand(sn=12.0), cand(sn=12.0, dm=10.0, i0=3000, i1=3010),
            cand(sn=5.0, i0=7000, i1=7010)],
        1: [cand(sn=9.0, i0=1003, i1=1013),
            cand(sn=12.0, dm=10.0, i0=3001, i1=3011),
            cand(sn=5.0, i0=7001, i1=7011)],
    }
    out = trig.coincidence(per_beam, TSAMP)
    trigs = trig.make_triggers(out, utc_start=1700000000.0, cfg=cfg)
    # only the first event passes: second fails DM>20, third fails S/N
    assert len(trigs) == 1
    t = trigs[0]
    assert t.sn == 12.0
    # window: i0*tsamp - 0.1 relative to utc_start
    assert abs(t.t0 - (1700000000.0 + 1000 * TSAMP - 0.1)) < 1e-6
    assert t.t1 > t.t0
    assert (t.t1 - t.t0) <= cfg.max_dump_s


def test_single_beam_no_trigger():
    per_beam = {0: [cand(sn=50.0)]}
    out = trig.coincidence(per_beam, TSAMP)
    trigs = trig.make_triggers(out, 0.0)
    assert trigs == []


def test_trigger_wire_roundtrip():
    t = trig.Trigger(t0=1.5, t1=3.25, sn=12.5, dm=80.0, width=0.004,
                     peak_time=2.0, meta="beam3 nbeam4")
    t2 = trig.Trigger.unpack(t.pack())
    assert t2.t0 == t.t0 and t2.t1 == t.t1
    assert abs(t2.sn - t.sn) < 1e-6
    assert t2.meta == t.meta


def test_trigger_udp_fanout():
    import time as _t
    rx = trig.TriggerReceiver(port=37903)
    tx = trig.TriggerSender([("127.0.0.1", 37903)])
    try:
        t = trig.Trigger(t0=10.0, t1=12.0, sn=9.5, dm=55.0, width=0.004,
                         peak_time=11.0, meta="fanout")
        tx.send(t)
        _t.sleep(0.2)
        got = rx.poll()
        assert len(got) == 1
        assert got[0].t0 == 10.0 and abs(got[0].dm - 55.0) < 1e-6
        assert got[0].meta == "fanout"
    finally:
        tx.close()
        rx.close()


def test_window_merge():
    cfg = TriggerConfig()
    # two coincident events overlapping in time merge into one dump window
    per_beam = {
        0: [cand(sn=12.0, i0=1000, i1=1010), cand(sn=15.0, i0=1100, i1=1110)],
        1: [cand(sn=12.0, i0=1001, i1=1011), cand(sn=15.0, i0=1101, i1=1111)],
    }
    out = trig.coincidence(per_beam, TSAMP)
    trigs = trig.make_triggers(out, 0.0, cfg)
    assert len(trigs) == 1
    assert trigs[0].sn == 15.0


def test_trigger_legacy_wire_format():
    """The reference's Python coincidencer packs 'dd128s' (144 B,
    src/trigger.py:174) while its C dumper expects the full trigger_t
    (src/utils.h:47-57) — our canonical format.  unpack() must accept
    the short legacy datagram and default the missing fields."""
    import struct
    t = trig.Trigger(t0=1.5, t1=3.25, sn=12.5, dm=80.0, width=0.004,
                     peak_time=2.0, meta="legacy")
    legacy = t.pack_legacy()
    assert len(legacy) == struct.calcsize("<dd128s")
    t2 = trig.Trigger.unpack(legacy)
    assert t2.t0 == 1.5 and t2.t1 == 3.25 and t2.meta == "legacy"
    assert t2.sn == 0.0 and t2.dm == 0.0
    # canonical stays byte-compatible with the C struct layout
    assert len(t.pack()) == struct.calcsize("<ddffff128s")


def test_trigger_truncated_datagram_raises():
    """Only an EXACT 144-byte datagram is the legacy layout; a canonical
    trigger_t truncated to 145-159 bytes must raise loudly instead of
    misparsing its sn/dm/width bytes into the meta field."""
    import struct
    t = trig.Trigger(t0=1.5, t1=3.25, sn=12.5, dm=80.0, width=0.004,
                     peak_time=2.0, meta="trunc")
    for n in (150, 159, 100, 10):
        with pytest.raises(struct.error):
            trig.Trigger.unpack(t.pack()[:n])


def test_coadd_snr_bar_above_beam_bar():
    """Coadd-beam candidates bypass min_beams, so their default S/N bar
    must sit ABOVE the per-beam trigger threshold (ADVICE r2)."""
    cfg = TriggerConfig()
    assert cfg.coadd_snr_thresh > cfg.snr_thresh
