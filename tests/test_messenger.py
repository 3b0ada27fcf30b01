"""Messenger service tests (document feed -> commands + archives)."""

import os
import time

import pytest

from vlite_fast.runtime.control import Command, ObservationDocument
from vlite_fast.runtime.messenger import Messenger, MessengerConfig
from test_aux import OBS_XML, FINISH_XML, ANTPROP_XML, ALERT_XML


def test_feed_documents(tmp_path):
    m = Messenger(MessengerConfig(archive_dir=str(tmp_path)))
    try:
        cmds = m.feed_xml(OBS_XML)
        assert cmds == [Command.START]
        assert m.sm.recording
        # antprop stored + positions exposed
        assert m.feed_xml(ANTPROP_XML) == []
        pos = m.antenna_positions()
        assert 5 in pos and pos[5][0] == -1601.2
        # alert recorded
        assert m.feed_xml(ALERT_XML) == []
        assert m.alerts[-1].vla_ant == 7
        # FINISH stops
        assert m.feed_xml(FINISH_XML) == [Command.STOP]
        assert not m.sm.recording
        archived = os.listdir(tmp_path)
        assert any("obsinfo" in f for f in archived)
        assert any("antprop" in f for f in archived)
    finally:
        m.shutdown()


def test_pointing_continuity(tmp_path):
    m = Messenger(MessengerConfig())
    try:
        od1 = ObservationDocument(name="A", ra=1.0, dec=0.5, scan_no=2)
        od2 = ObservationDocument(name="A", ra=1.0001, dec=0.5, scan_no=3)
        od3 = ObservationDocument(name="B", ra=2.0, dec=0.1, scan_no=4)
        assert m.feed_observation(od1) == [Command.START]
        assert m.feed_observation(od2) == []            # keep integrating
        assert m.feed_observation(od3) == [Command.STOP, Command.START]
    finally:
        m.shutdown()


def test_udp_ingest_and_bus():
    import socket
    m = Messenger(MessengerConfig(obsinfo_port=38011, command_port=38012))
    try:
        from vlite_fast.runtime.control import CommandClient
        cli = CommandClient(port=38012)
        time.sleep(0.3)
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        s.sendto(OBS_XML.encode(), ("127.0.0.1", 38011))
        s.sendto(b"<garbage", ("127.0.0.1", 38011))   # must not kill leader
        s.sendto(FINISH_XML.encode(), ("127.0.0.1", 38011))
        deadline = time.time() + 5
        got = []
        while time.time() < deadline and len(got) < 2:
            got.extend(cli.poll())
            time.sleep(0.05)
        assert [c for c, _ in got] == [Command.START, Command.STOP]
        assert got[0][1].name == "J0534+2200"
        cli.close()
        s.close()
    finally:
        m.shutdown()


def test_source_whitelist():
    """check_name/check_id/check_coords policy (ref src/util.c:91-152)."""
    from vlite_fast.runtime.sources import SourceWhitelist, coord_dist
    wl = SourceWhitelist()
    assert wl.check_name("PSR B0329+54 drift")
    assert wl.check_name("R3")
    assert not wl.check_name("J9999+99")
    assert wl.check_id("TSKY0001.sb.18B-405.eb123")
    assert not wl.check_id("20A-000")
    assert wl.check_coords(1.1448, 1.2857)          # arr2 position
    assert not wl.check_coords(0.0, 0.0)
    assert coord_dist(0.0, 0.0, 0.5, 0.5) == 0.0
    # file round-trip
    import tempfile, os
    with tempfile.TemporaryDirectory() as d:
        pth = os.path.join(d, "src.json")
        wl.save(pth)
        wl2 = SourceWhitelist.load(pth)
        assert wl2.names == wl.names and wl2.positions == wl.positions


def test_messenger_source_of_interest_alert():
    from vlite_fast.runtime.messenger import Messenger, MessengerConfig
    from vlite_fast.runtime.control import ObservationDocument
    hits = []
    m = Messenger(MessengerConfig(
        notify=lambda subj, body: hits.append((subj, body))))
    m.feed_observation(ObservationDocument(
        name="B0329+54", ra=0.9, dec=0.95, scan_no=2, start_time=1e9))
    assert len(hits) == 1 and "B0329+54" in hits[0][0]
    # an uninteresting source does not alert
    m.feed_observation(ObservationDocument(
        name="J9999+99", ra=2.0, dec=0.1, scan_no=3, start_time=1e9))
    assert len(hits) == 1
    m.shutdown()


def test_leader_manual_port():
    """The messenger -m telnet role (ref messenger.c:389-414): one-char
    commands over TCP drive the bus."""
    import socket
    import time as _t

    from vlite_fast.config import ArrayConfig
    from vlite_fast.runtime.control import Command
    from vlite_fast.runtime.leader_main import Leader

    acfg = ArrayConfig.tiny(nant=2, command_port=23501,
                            coincidencer_port=23555,
                            trigger_port_base=23600)
    leader = Leader(acfg, "/tmp/vfast_leader_test", manual_port=23510)
    try:
        seen = []
        leader.messenger.bus.subscribe(lambda c, od: seen.append(c))
        with socket.create_connection(("127.0.0.1", 23510), timeout=5) as s:
            s.sendall(b"F\n")
        deadline = _t.time() + 5
        while not seen and _t.time() < deadline:
            _t.sleep(0.05)
        assert seen == [Command.FAKE_START]
        # unknown command must not kill the leader
        with socket.create_connection(("127.0.0.1", 23510), timeout=5) as s:
            s.sendall(b"Z\n")
        _t.sleep(0.3)
        assert leader._running
    finally:
        leader.shutdown()
