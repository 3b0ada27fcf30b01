"""UDP capture soak: sustain the production wire rate over localhost.

Round-1 left the Python UDP receive loop unproven against the 51,200
frames/s/antenna wire rate (256 MB/s, ref src/def.h:22-23; the reference
drains 20 packets per select wake from PF_PACKET, writer.c:611-614).
This drives the production path — recvmmsg batch drain (csrc/netcap.cpp)
-> vectorized SecondAssembler -> shm ring — from a forked sender process
blasting real 5032-byte VDIF frames at localhost.

Run: python benchmarks/bench_udp.py [seconds] [rate_frames_per_sec] [udp|raw]
`raw` soaks the AF_PACKET transport instead (RawCapture — the reference's
production capture path, src/utils.c:345-407): the same UDP blast over
loopback is captured OFF THE WIRE with the 42-byte encapsulation stripped
in the C helper.  Requires CAP_NET_RAW.
Prints one JSON line with achieved receive/assembly rates.
"""

import sys
import os
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import json
import socket
import time

import numpy as np

from vlite_fast import constants as C
from vlite_fast.runtime import capture
from vlite_fast.runtime.ring import RingBuffer
from vlite_fast.utils import vdif


def build_frames(nsec: int):
    """Built ONCE in the parent before forking (COW-shared): frame
    synthesis of a full second costs seconds and must not eat into the
    measured window.  Returns one contiguous byte stream per second."""
    rate = C.VLITE_RATE
    samples = np.random.default_rng(0).integers(
        1, 255, (2, rate), dtype=np.uint8)
    return [vdif.streams_to_frames(samples, ref_epoch=10,
                                   start_second=100 + sec,
                                   sample_rate=rate)
            for sec in range(nsec)]


def sender_proc(port: int, frames, fps_total: int, lib):
    """Child: blast the prebuilt frames at the wire rate via sendmmsg
    (csrc udp_blast — a Python sendto loop tops out ~44k/s, below the
    51,200/s wire rate)."""
    import ctypes
    tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    tx.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, 64 << 20)
    tx.connect(("127.0.0.1", port))
    fb = C.VDIF_FRAME_BYTES
    t0 = time.perf_counter()
    sent = 0
    for stream in frames:
        nf = stream.size // fb
        off = 0
        while off < nf:
            chunk = min(512, nf - off)
            k = lib.udp_blast(
                tx.fileno(),
                stream[off * fb:].ctypes.data_as(ctypes.c_void_p),
                fb, chunk)
            if k <= 0:
                time.sleep(0.001)
                continue
            off += k
            sent += k
            ahead = sent / fps_total - (time.perf_counter() - t0)
            if ahead > 0.02:
                time.sleep(ahead)
    dt = time.perf_counter() - t0
    os.write(2, f"sender: {sent} frames in {dt:.2f}s "
                f"({sent/dt:.0f}/s)\n".encode())
    tx.close()
    os._exit(0)


def main():
    nsec = int(sys.argv[1]) if len(sys.argv) > 1 else 3
    fps_total = int(sys.argv[2]) if len(sys.argv) > 2 else 2 * C.FRAMES_PER_SEC
    transport = sys.argv[3] if len(sys.argv) > 3 else "udp"

    sink = None
    if transport == "raw":
        # a bound (never-read) UDP socket owns the port so the kernel
        # doesn't answer every frame with ICMP port-unreachable; the
        # AF_PACKET tap sees the packets regardless of the UDP queue
        sink = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        sink.bind(("127.0.0.1", 0))
        port = sink.getsockname()[1]
        rx = capture.RawCapture(iface="lo", port=port,
                                sample_rate=C.VLITE_RATE, batch=1024)
    else:
        rx = capture.UDPCapture(port=0, sample_rate=C.VLITE_RATE,
                                batch=1024)
        port = rx.sock.getsockname()[1]
    assert rx._lib is not None, "netcap helper missing"
    ring = RingBuffer("/vfast_udp_soak", bufsz=2 * C.VLITE_RATE, nbufs=2,
                      create=True)
    warm = np.zeros(2 * C.VLITE_RATE, np.uint8)
    for _ in range(2):
        ring.write(warm, timestamp=0.0, overwrite=True)
    frames = build_frames(nsec)

    pid = os.fork()
    if pid == 0:
        sender_proc(port, frames, fps_total, rx._lib)

    total_frames = nsec * fps_total
    done_secs = 0
    t0 = time.perf_counter()
    t_first = None                   # active window starts at first frame
    deadline = t0 + nsec + 15
    while time.perf_counter() < deadline:
        for sec, buf in rx.poll(max_frames=1024):
            ring.write(buf.reshape(-1), timestamp=float(sec),
                       overwrite=True)
            done_secs += 1
        got = rx.asm.stats.frames + rx.asm.stats.skipped
        if got and t_first is None:
            t_first = time.perf_counter()
        if got >= total_frames - rx.asm.frames_per_sec:
            break
    dt = time.perf_counter() - (t_first or t0)
    os.waitpid(pid, 0)
    st = rx.asm.stats
    rx.close()
    if sink is not None:
        sink.close()
    ring.close(unlink=True)
    received = st.frames
    print(json.dumps({
        "metric": f"{transport.upper()} capture soak "
                  "(batch drain + assembler + shm ring)",
        "transport": transport,
        "target_frames_per_s": fps_total,
        "achieved_frames_per_s": round(received / dt),
        "wall_s": round(dt, 2),
        "frames_received": received,
        "frames_lost": st.skipped,
        "loss_fraction": round(st.skipped / max(1, received + st.skipped),
                               5),
        "seconds_assembled": done_secs,
        "sustained_wire_rate": bool(received / dt >= 51_200
                                    and st.skipped / max(1, received)
                                    < 0.01),
    }))


if __name__ == "__main__":
    main()
