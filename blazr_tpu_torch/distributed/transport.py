"""Point-to-point tagged transport and rank bootstrap.

The port's own copy of ``blazr_tpu/distributed/transport.py`` (pure Python:
sockets and queues; the port imports nothing of the JAX package). The swarm
and disagg modes ride this tagged byte transport: the leader (rank 0)
bootstraps, workers connect to its seed address, announce their listen
port and receive their rank and the address book; then every pair talks
over its own TCP connection. It carries the control messages (assignment,
model path, readiness), the pipeline's activations and the disagg KV.

Wire format: ``[u32 tag][u32 src_rank][u64 len][payload]`` little-endian.
``announce_seed``/``discover_seed`` find the leader on a LAN by a UDP
beacon (``swarm --mdns``).
"""

from __future__ import annotations

import logging
import queue
import socket
import struct
import threading
import time
from dataclasses import dataclass
from typing import Optional

logger = logging.getLogger(__name__)


# Well-known tags (reference transport::tags, SURVEY §2.9).
class tags:
    MODEL_PATH = 1
    WORKER_READY = 2
    ASSIGNMENT = 3
    ACTIVATION = 4
    LOGITS = 5
    KV_CACHE = 6
    REQUEST = 7
    RESPONSE = 8
    SHUTDOWN = 9
    ADDRESS_BOOK = 10


_HDR = struct.Struct("<IIQ")


def _send_msg(sock: socket.socket, tag: int, src: int, payload: bytes) -> None:
    sock.sendall(_HDR.pack(tag, src, len(payload)) + payload)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed")
        buf += chunk
    return bytes(buf)


def _recv_msg(sock: socket.socket) -> tuple[int, int, bytes]:
    tag, src, ln = _HDR.unpack(_recv_exact(sock, _HDR.size))
    return tag, src, _recv_exact(sock, ln)


@dataclass
class PeerInfo:
    rank: int
    host: str
    port: int


class TcpMesh:
    """Full point-to-point mesh with tagged queues.

    Leader (rank 0) bootstraps: workers connect to the seed address,
    announce their listen port, receive their rank + the address book
    (reference bootstrap_local / WorkerNode::connect,
    cli/swarm.rs:156-266).
    """

    def __init__(self, rank: int, world_size: int, peers: dict[int, PeerInfo],
                 listener: socket.socket):
        self.rank = rank
        self.world_size = world_size
        self.peers = peers
        self._listener = listener
        self._out: dict[int, socket.socket] = {}
        self._queues: dict[tuple[int, int], "queue.Queue[bytes]"] = {}
        self._qlock = threading.Lock()
        self._stop = threading.Event()
        self._accept_thread = threading.Thread(target=self._accept_loop,
                                               daemon=True)
        self._accept_thread.start()

    # ---- bootstrap -------------------------------------------------------
    @classmethod
    def bootstrap_leader(cls, world_size: int, host: str = "127.0.0.1",
                         seed_port: int = 0) -> "TcpMesh":
        seed = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        seed.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        seed.bind((host, seed_port))
        seed.listen(world_size)
        cls._seed_addr = seed.getsockname()

        listener = cls._make_listener(host)
        my_info = PeerInfo(0, host, listener.getsockname()[1])
        peers = {0: my_info}
        conns = []
        for _ in range(world_size - 1):
            conn, _ = seed.accept()
            tag, _, payload = _recv_msg(conn)
            assert tag == tags.WORKER_READY
            w_host, w_port = payload.decode().split(":")
            rank = len(peers)
            peers[rank] = PeerInfo(rank, w_host, int(w_port))
            conns.append((rank, conn))
        # Broadcast ranks + address book.
        book = ";".join(f"{p.rank}={p.host}:{p.port}"
                        for p in peers.values()).encode()
        for rank, conn in conns:
            _send_msg(conn, tags.ADDRESS_BOOK, 0,
                      struct.pack("<II", rank, world_size) + book)
            conn.close()
        seed.close()
        return cls(0, world_size, peers, listener)

    @classmethod
    def bootstrap_worker(cls, seed_addr: tuple[str, int],
                         host: str = "127.0.0.1",
                         timeout: float = 30.0) -> "TcpMesh":
        listener = cls._make_listener(host)
        deadline = time.time() + timeout
        while True:
            try:
                s = socket.create_connection(seed_addr, timeout=5)
                break
            except OSError:
                if time.time() > deadline:
                    raise
                time.sleep(0.1)
        _send_msg(s, tags.WORKER_READY, 0,
                  f"{host}:{listener.getsockname()[1]}".encode())
        tag, _, payload = _recv_msg(s)
        assert tag == tags.ADDRESS_BOOK
        rank, world_size = struct.unpack_from("<II", payload)
        peers = {}
        for ent in payload[8:].decode().split(";"):
            r, addr = ent.split("=")
            h, p = addr.rsplit(":", 1)
            peers[int(r)] = PeerInfo(int(r), h, int(p))
        s.close()
        return cls(rank, world_size, peers, listener)

    @staticmethod
    def _make_listener(host: str) -> socket.socket:
        l = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        l.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        l.bind((host, 0))
        l.listen(64)
        return l

    # ---- data plane ------------------------------------------------------
    def send(self, dst: int, tag: int, payload: bytes) -> None:
        sock = self._out.get(dst)
        if sock is None:
            info = self.peers[dst]
            sock = socket.create_connection((info.host, info.port), timeout=30)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._out[dst] = sock
        _send_msg(sock, tag, self.rank, payload)

    def recv(self, src: int, tag: int, timeout: Optional[float] = 60.0) -> bytes:
        q = self._queue(src, tag)
        return q.get(timeout=timeout)

    def _queue(self, src: int, tag: int) -> "queue.Queue[bytes]":
        with self._qlock:
            key = (src, tag)
            q = self._queues.get(key)
            if q is None:
                q = queue.Queue()
                self._queues[key] = q
            return q

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                self._listener.settimeout(0.5)
                conn, _ = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            threading.Thread(target=self._reader, args=(conn,),
                             daemon=True).start()

    def _reader(self, conn: socket.socket) -> None:
        try:
            while not self._stop.is_set():
                tag, src, payload = _recv_msg(conn)
                self._queue(src, tag).put(payload)
        except (ConnectionError, OSError):
            pass

    def close(self) -> None:
        self._stop.set()
        for s in self._out.values():
            try:
                s.close()
            except OSError:
                pass
        try:
            self._listener.close()
        except OSError:
            pass


# ---------------------------------------------------------------------------
# LAN seed discovery (reference --mdns flag, cli/commands.rs:300-302:
# nexar's optional mDNS worker discovery; here a UDP broadcast beacon —
# same operational contract: workers find the leader without --seed)
# ---------------------------------------------------------------------------

DISCOVERY_PORT = 29529
_BEACON_MAGIC = b"blazr-tpu-seed "


def announce_seed(host: str, port: int,
                  discovery_port: int = DISCOVERY_PORT,
                  interval: float = 1.0) -> "threading.Event":
    """Broadcast the seed address on the LAN from a daemon thread until
    the returned Event is set. Runs concurrently with bootstrap_leader
    (which blocks until every worker connects)."""
    stop = threading.Event()
    payload = _BEACON_MAGIC + f"{host}:{port}".encode()

    def loop():
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_BROADCAST, 1)
        while not stop.is_set():
            for dst in ("255.255.255.255", "127.0.0.1"):
                try:
                    s.sendto(payload, (dst, discovery_port))
                except OSError:
                    pass
            stop.wait(interval)
        s.close()

    threading.Thread(target=loop, daemon=True).start()
    return stop


def discover_seed(timeout: float = 30.0,
                  discovery_port: int = DISCOVERY_PORT) -> tuple[str, int]:
    """Listen for a leader beacon; returns (host, port) of the seed.
    Raises TimeoutError when no beacon arrives in ``timeout`` seconds."""
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    try:  # several workers on one host listen on the same port
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
    except (AttributeError, OSError):   # pragma: no cover — platform
        pass
    s.bind(("", discovery_port))
    s.settimeout(timeout)
    deadline = time.time() + timeout
    try:
        while True:
            remaining = deadline - time.time()
            if remaining <= 0:
                raise TimeoutError("no leader beacon heard")
            s.settimeout(remaining)
            try:
                data, addr = s.recvfrom(256)
            except socket.timeout:
                raise TimeoutError("no leader beacon heard")
            if data.startswith(_BEACON_MAGIC):
                host, port = data[len(_BEACON_MAGIC):].decode().rsplit(":", 1)
                if host in ("0.0.0.0", ""):
                    host = addr[0]      # beacon sender is the leader
                return host, int(port)
    finally:
        s.close()
