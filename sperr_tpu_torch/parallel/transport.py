"""Host-side byte transport for multi-process runs (the data plane).

Port of sperr_tpu/parallel/transport.py.  Compressed payloads are host
bytes, not device tensors.  The reference's pattern is an ordered gather to
rank 0 (SPERR3D_OMP_C.cpp:145-161): only the root receives, and only actual
bytes travel.  This module provides that as a pluggable transport:

  * ``SocketGatherTransport`` — plain TCP gather-to-0: rank 0 listens, every
    other rank connects and streams ``{pid u32, len u64, payload}``.  No
    padding, no broadcast; total traffic = sum(len).  The root address comes
    from the constructor or ``SPERR_TPU_GATHER_ADDR`` (host:port), the
    variable the JAX package reads too.
  * ``AllgatherTransport`` — fallback riding torch.distributed: an
    all-gather of the lengths, then of the max-padded bytes, as CPU tensors
    over a gloo group (it over-ships: every rank receives everything,
    padded).  Gloo also lets several ranks share one card, which NCCL
    refuses.
  * ``LocalTransport`` — single-process identity.

``gather_bytes(payload, pid, nprocs)`` returns the ordered list of payloads
on rank 0 and None elsewhere.
"""

from __future__ import annotations

import os
import socket
import struct
import threading
from typing import List, Optional

_HDR = struct.Struct("<IQ")  # pid u32, payload length u64


def _recv_exact(conn: socket.socket, ln: int) -> bytes:
    parts = []
    got = 0
    while got < ln:
        b = conn.recv(min(1 << 20, ln - got))
        if not b:
            raise ConnectionError("gather sender closed early")
        parts.append(b)
        got += len(b)
    return b"".join(parts)


class LocalTransport:
    def gather_bytes(self, payload: bytes, pid: int, nprocs: int):
        assert nprocs == 1
        return [payload]


_GLOO_GROUPS: dict = {}  # default group -> the gloo group made for it


def _gloo_group():
    """The default process group where its backend is gloo, else one gloo
    group over the same ranks, made on first use (a collective call) and
    kept for that default group."""
    import torch.distributed as dist

    world = dist.group.WORLD
    if dist.get_backend() == "gloo":
        return world
    group = _GLOO_GROUPS.get(world)
    if group is None:
        group = _GLOO_GROUPS[world] = dist.new_group(backend="gloo")
    return group


class AllgatherTransport:
    """Max-padded uint8 all-gather via torch.distributed (fallback path)."""

    def gather_bytes(self, payload: bytes, pid: int, nprocs: int):
        if nprocs == 1:
            return [payload]
        import numpy as np
        import torch
        import torch.distributed as dist

        group = _gloo_group()
        lengths = [torch.zeros(1, dtype=torch.int64) for _ in range(nprocs)]
        dist.all_gather(lengths, torch.tensor([len(payload)], dtype=torch.int64), group=group)
        lengths = [int(t[0]) for t in lengths]
        maxlen = max(1, max(lengths))  # gloo is given no empty tensor
        buf = torch.zeros(maxlen, dtype=torch.uint8)
        buf[: len(payload)] = torch.from_numpy(np.frombuffer(payload, dtype=np.uint8).copy())
        gathered = [torch.empty(maxlen, dtype=torch.uint8) for _ in range(nprocs)]
        dist.all_gather(gathered, buf, group=group)
        out = [gathered[p][: lengths[p]].numpy().tobytes() for p in range(nprocs)]
        return out if pid == 0 else None


class SocketGatherTransport:
    """Ordered TCP gather to rank 0: the reference's serial gather point,
    across hosts.  Root binds ``addr`` before (or as) senders connect;
    senders retry the connect until the listener is up (bounded by
    ``timeout``)."""

    def __init__(self, addr: Optional[str] = None, timeout: float = 120.0):
        addr = addr or os.environ.get("SPERR_TPU_GATHER_ADDR")
        if not addr:
            raise ValueError(
                "SocketGatherTransport needs host:port (arg or "
                "SPERR_TPU_GATHER_ADDR)"
            )
        host, port = addr.rsplit(":", 1)
        self.host, self.port = host, int(port)
        self.timeout = timeout

    def gather_bytes(self, payload: bytes, pid: int, nprocs: int):
        if nprocs == 1:
            return [payload]
        if pid == 0:
            return self._root(payload, nprocs)
        self._send(payload, pid)
        return None

    def _root(self, own: bytes, nprocs: int) -> List[bytes]:
        out: List[Optional[bytes]] = [None] * nprocs
        out[0] = own
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind((self.host, self.port))
        srv.listen(nprocs)
        srv.settimeout(self.timeout)
        try:
            # each peer connection is drained on its own thread so a slow
            # sender doesn't serialize the gather
            def drain(conn):
                with conn:
                    hdr = _recv_exact(conn, _HDR.size)
                    spid, ln = _HDR.unpack(hdr)
                    out[spid] = _recv_exact(conn, ln)

            threads = []
            for _ in range(nprocs - 1):
                conn, _ = srv.accept()
                t = threading.Thread(target=drain, args=(conn,))
                t.start()
                threads.append(t)
            for t in threads:
                t.join(self.timeout)
        finally:
            srv.close()
        missing = [p for p, b in enumerate(out) if b is None]
        if missing:
            raise ConnectionError(f"gather missing payloads from ranks {missing}")
        return out  # type: ignore[return-value]

    def _send(self, payload: bytes, pid: int) -> None:
        import time

        deadline = time.monotonic() + self.timeout
        while True:
            try:
                conn = socket.create_connection(
                    (self.host, self.port), timeout=self.timeout
                )
                break
            except OSError:
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.05)
        with conn:
            conn.sendall(_HDR.pack(pid, len(payload)))
            conn.sendall(payload)


def default_transport(nprocs: int):
    if nprocs == 1:
        return LocalTransport()
    if os.environ.get("SPERR_TPU_GATHER_ADDR"):
        return SocketGatherTransport()
    return AllgatherTransport()
