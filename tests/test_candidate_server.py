"""Cross-host coincidencer service tests (the trigger.py server role)."""

import time

import pytest

from vlite_fast.config import TriggerConfig
from vlite_fast.ops.dedisperse import Candidate
from vlite_fast.runtime.candidate_server import (CandidateClient,
                                                     CoincidencerServer,
                                                     format_batch,
                                                     parse_batch)

TSAMP = 1.0 / 1280


def cand(sn=12.0, dm=80.0, i0=1000, i1=1010):
    return Candidate(snr=sn, peak_idx=(i0 + i1) // 2,
                     peak_time=(i0 + i1) / 2 * TSAMP, tfilt=3, dmi=40,
                     dm=dm, ngiant=1, i0=i0, i1=i1)


def test_batch_roundtrip():
    cands = [cand(), cand(sn=9.0, i0=2000, i1=2020)]
    utc, beam, back = parse_batch(format_batch("2026-08-17-01:00:00", 3,
                                               cands))
    assert utc == "2026-08-17-01:00:00" and beam == 3
    assert len(back) == 2 and back[0].snr == 12.0 and back[1].i0 == 2000


def test_coincidence_over_tcp():
    got = []
    srv = CoincidencerServer(port=37555, tsamp=TSAMP,
                             tcfg=TriggerConfig(),
                             on_trigger=got.append)
    try:
        cli = CandidateClient(port=37555)
        utc = "1700000000"
        cli.send(utc, 0, [cand()])
        time.sleep(0.3)
        assert got == []            # single beam: no trigger yet
        cli.send(utc, 1, [cand(i0=1002, i1=1012)])
        deadline = time.time() + 20
        while not got and time.time() < deadline:
            time.sleep(0.05)
        assert len(got) == 1
        t = got[0]
        assert t.sn == 12.0
        assert abs(t.t0 - (1.7e9 + 1000 * TSAMP - 0.1)) < 1e-6
        # same candidates again: no duplicate trigger
        cli.send(utc, 0, [cand()])
        time.sleep(0.5)
        assert len(got) == 1
    finally:
        srv.close()


def test_garbage_batch_survives():
    srv = CoincidencerServer(port=37556, tsamp=TSAMP)
    try:
        import socket
        with socket.create_connection(("127.0.0.1", 37556)) as s:
            s.sendall(b"complete garbage\nmore garbage\n")
        time.sleep(0.3)
        # server still alive and functional
        cli = CandidateClient(port=37556)
        cli.send("1700000000", 0, [cand()])
        time.sleep(0.3)
        assert srv.utc_groups["1700000000"][0]
    finally:
        srv.close()
