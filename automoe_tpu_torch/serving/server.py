"""Micro-batching serving front-end over the InferenceEngine (a copy of
the JAX package's serving/server.py: numpy and sockets only).

`BatchingServer` collects concurrent requests for up to `max_wait_ms`,
pads the group to a fixed bucket size (so the engine only ever sees
len(buckets) batch shapes), runs ONE engine step, and fans the rows back
out to the waiting callers. A length-prefixed TCP front-end (`serve_tcp`)
exposes it to out-of-process clients; `Client` is the matching client.

`pipeline_depth >= 2` splits the worker into a dispatch stage (group
formation + upload + asynchronous enqueue of the step) and a fetch stage
(device-to-host copy + future resolution) with a bounded in-flight count,
so batch n+1's upload overlaps batch n's device step and result fetch.
With closed-loop clients (each blocking on its result) the outstanding
requests split across the in-flight batches and batches shrink, hence
the serve CLI defaults to 1.
"""
from __future__ import annotations

import json
import queue
import socket
import socketserver
import struct
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

# JSON headers are tiny; a 4-byte length prefix can claim up to 4 GiB —
# cap it so a malformed client can't force a huge buffered recv.
MAX_HEADER_BYTES = 64 * 1024


class BatchingServer:
    """Collects concurrent infer requests into bucketed device batches."""

    def __init__(
        self,
        engine,
        *,
        max_batch: int = 8,
        max_wait_ms: float = 5.0,
        buckets: Optional[Sequence[int]] = None,
        pipeline_depth: int = 1,
    ):
        self.engine = engine
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_ms) / 1e3
        # pipeline_depth >= 2 splits the worker into a dispatch stage
        # (form group -> upload + enqueue the engine step, async) and a
        # fetch stage (D2H + resolve futures), with at most
        # `pipeline_depth` batches in flight: batch n+1's H2D overlaps
        # batch n's device step + D2H. Requires the engine to expose
        # dispatch_batch/fetch (infer/engine.py); falls back to the
        # serial worker otherwise (e.g. ArtifactEngine).
        self.pipeline_depth = int(pipeline_depth)
        if self.pipeline_depth > 1 and not hasattr(engine, "dispatch_batch"):
            self.pipeline_depth = 1
        self._fly: Optional["queue.Queue"] = None
        self._fetcher: Optional[threading.Thread] = None
        # dispatched-but-not-yet-fetched batches. NOT the same as
        # _fly.qsize(): the fetch thread pops an item immediately and
        # then blocks in the fetch for ~the whole batch duration, so queue
        # occupancy undercounts in-flight work by one — the counter is
        # only decremented once the fetch completes.
        self._inflight = 0
        self._inflight_lock = threading.Lock()
        if buckets is None:
            buckets = []
            b = 1
            while b < self.max_batch:
                buckets.append(b)
                b *= 2
            buckets.append(self.max_batch)
        self.buckets = sorted(set(int(b) for b in buckets))
        if self.buckets[-1] < self.max_batch:
            raise ValueError("largest bucket must cover max_batch")
        self._q: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()
        self._worker: Optional[threading.Thread] = None
        self.stats = {
            "requests": 0,
            "batches": 0,
            "rows_padded": 0,
            "max_batch_seen": 0,
        }
        # per-request queue wait (submit → batch formed) and per-batch
        # device step time, seconds; ring buffers so stats stay O(1)
        self._queue_lat = deque(maxlen=2048)
        self._device_lat = deque(maxlen=2048)
        self._fetch_lat = deque(maxlen=2048)  # pipelined: D2H+resolve only
        self._lat_lock = threading.Lock()

    # -- lifecycle -------------------------------------------------------

    def start(self, warmup: bool = True):
        if warmup:
            h, w = self.engine.camera_hw
            for b in self.buckets:
                self.engine.infer_batch(
                    np.zeros((b, h, w, 3), np.uint8), np.zeros((b,))
                )
        if self.pipeline_depth > 1:
            self._fly = queue.Queue(maxsize=self.pipeline_depth)
            self._fetcher = threading.Thread(
                target=self._run_fetch, daemon=True
            )
            self._fetcher.start()
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()
        return self

    def close(self):
        self._stop.set()
        if self._worker is not None:
            self._worker.join(timeout=5)
            self._worker = None
        if self._fetcher is not None:
            # bounded-queue sentinel: a full pipe + a slow D2H would make
            # a plain put() block close() indefinitely — retry with a
            # timeout and bail if the fetcher already died
            while self._fetcher.is_alive():
                try:
                    self._fly.put(None, timeout=1.0)  # sentinel
                    break
                except queue.Full:
                    continue
            self._fetcher.join(timeout=10)
            # NEVER null out _fly: a fetcher that outlives the join
            # timeout (stuck in a D2H copy) still references it
            self._fetcher = None
        # resolve abandoned requests so callers blocked in .result() wake
        while True:
            try:
                _, _, fut, _ = self._q.get_nowait()
            except queue.Empty:
                break
            if not fut.done():
                fut.set_exception(RuntimeError("server closed"))

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.close()

    # -- client API ------------------------------------------------------

    def submit(self, frame_u8: np.ndarray, speed_kmh: float) -> Future:
        """Enqueue one frame; resolves to {waypoints, speed, speed_seq,
        expert_weights} rows (no batch dim)."""
        if self._worker is None:
            raise RuntimeError("server not started")
        frame = np.asarray(frame_u8, np.uint8)
        # validate here so one bad client can't land a mismatched frame in
        # a batching window (np.stack across the group would raise and,
        # unhandled, kill the worker for everyone)
        expect = (*self.engine.camera_hw, 3)
        if frame.shape != expect:
            raise ValueError(
                f"frame shape {frame.shape} != engine camera {expect}"
            )
        fut: Future = Future()
        self._q.put((frame, float(speed_kmh), fut, time.perf_counter()))
        return fut

    def infer(self, frame_u8: np.ndarray, speed_kmh: float) -> Dict[str, np.ndarray]:
        return self.submit(frame_u8, speed_kmh).result()

    # -- worker ----------------------------------------------------------

    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if b >= n:
                return b
        return self.buckets[-1]

    def _run(self):
        proc = self._dispatch if self.pipeline_depth > 1 else self._process
        while not self._stop.is_set():
            try:
                first = self._q.get(timeout=0.05)
            except queue.Empty:
                continue
            group = [first]
            deadline = time.perf_counter() + self.max_wait_s
            while len(group) < self.max_batch:
                remain = deadline - time.perf_counter()
                if remain <= 0:
                    break
                try:
                    group.append(self._q.get(timeout=remain))
                except queue.Empty:
                    break
            # Backpressure-adaptive grouping (pipelined mode): while the
            # pipeline already holds `pipeline_depth` unfetched batches,
            # dispatching another buys no overlap — it would only cut
            # this group short and pad it to its bucket, and every
            # padded slot costs a full frame of H2D bytes. Keep
            # absorbing arrivals into THIS group until a slot frees.
            # (This is a deliberate 2 ms bounded poll, not a condition
            # wait: the loop must wake on EITHER a new arrival (absorb it
            # into this group) OR a freed pipeline slot, and a dual-wait
            # needs machinery whose complexity isn't paid for by the
            # ~500 idle wakeups/s this costs while the pipe is full.)
            if self._fly is not None:
                while (len(group) < self.max_batch
                       and self._in_flight() >= self.pipeline_depth
                       and not self._stop.is_set()):
                    try:
                        group.append(self._q.get(timeout=0.002))
                    except queue.Empty:
                        pass
            try:
                proc(group)
            except Exception as e:  # never let the worker die
                for _, _, fut, _ in group:
                    if not fut.done():
                        fut.set_exception(e)

    def _form_arrays(self, group):
        frames = np.stack([g[0] for g in group])
        speeds = np.asarray([g[1] for g in group], np.float32)
        n = len(group)
        b = self._bucket_for(n)
        if b > n:  # pad by repeating the last row — static shapes
            frames = np.concatenate(
                [frames, np.repeat(frames[-1:], b - n, axis=0)]
            )
            speeds = np.concatenate([speeds, np.repeat(speeds[-1:], b - n)])
        return frames, speeds, n, b

    def _record(self, group, n: int, b: int, t_formed: float, t_done: float,
                fetch_s: Optional[float] = None):
        self.stats["requests"] += n
        self.stats["batches"] += 1
        self.stats["rows_padded"] += b - n
        self.stats["max_batch_seen"] = max(self.stats["max_batch_seen"], n)
        with self._lat_lock:
            self._device_lat.append(t_done - t_formed)
            if fetch_s is not None:
                self._fetch_lat.append(fetch_s)
            for _, _, _, t_enq in group:
                self._queue_lat.append(t_formed - t_enq)

    @staticmethod
    def _claim(group):
        """Transition every future to RUNNING, dropping ones the caller
        already cancelled (fut.cancel() while PENDING succeeds — the
        standard client timeout pattern). After this, cancel() can no
        longer win a race against set_result, so resolving a claimed
        future cannot raise InvalidStateError and kill a worker thread."""
        return [g for g in group if g[2].set_running_or_notify_cancel()]

    def _process(self, group):
        group = self._claim(group)
        if not group:
            return
        t_formed = time.perf_counter()
        try:
            frames, speeds, n, b = self._form_arrays(group)
            out = self.engine.infer_batch(frames, speeds)
        except Exception as e:  # propagate to every caller
            for _, _, fut, _ in group:
                if not fut.done():
                    fut.set_exception(e)
            return
        t_done = time.perf_counter()
        self._record(group, n, b, t_formed, t_done)
        for i, (_, _, fut, _) in enumerate(group):
            if not fut.done():
                fut.set_result({k: v[i] for k, v in out.items()})

    # -- pipelined worker (pipeline_depth >= 2) ----------------------------
    #
    # Dispatch stage: upload + enqueue the engine step (async) and
    # hand the un-fetched device outputs to the fetch stage through a
    # bounded queue — so batch n+1's group formation + H2D runs while
    # batch n is still on the device / in D2H. The bounded queue is the
    # backpressure: at most `pipeline_depth` batches in flight.

    def _in_flight(self) -> int:
        with self._inflight_lock:
            return self._inflight

    def _dispatch(self, group):
        group = self._claim(group)
        if not group:
            return
        t_formed = time.perf_counter()
        try:
            frames, speeds, n, b = self._form_arrays(group)
            out, real_b = self.engine.dispatch_batch(frames, speeds)
        except Exception as e:
            for _, _, fut, _ in group:
                if not fut.done():
                    fut.set_exception(e)
            return
        with self._inflight_lock:
            self._inflight += 1
        self._fly.put((group, out, real_b, n, b, t_formed))

    def _run_fetch(self):
        fly = self._fly  # bind once: close() must never None this out
        while True:
            item = fly.get()
            if item is None:  # close() sentinel, queue already drained
                return
            group, out, real_b, n, b, t_formed = item
            # the whole item is handled under try/finally: ANY exception
            # (engine fetch, stats, a result dict surprise) fails that
            # one batch instead of killing the fetch thread — a dead
            # fetcher would strand _inflight high and deadlock the
            # worker's backpressure loop for every future client.
            try:
                t_fetch0 = time.perf_counter()
                host = self.engine.fetch(out, real_b)
                t_done = time.perf_counter()
                self._record(group, n, b, t_formed, t_done,
                             fetch_s=t_done - t_fetch0)
                for i, (_, _, fut, _) in enumerate(group):
                    if not fut.done():
                        fut.set_result({k: v[i] for k, v in host.items()})
            except Exception as e:
                for _, _, fut, _ in group:
                    if not fut.done():
                        fut.set_exception(e)
            finally:
                with self._inflight_lock:
                    self._inflight -= 1

    def stats_snapshot(self) -> Dict:
        """Counters plus p50/p99 queue-wait and device-step latency (ms)
        over the last ≤2048 requests/batches — makes the max_wait_ms /
        bucket tradeoff measurable in deployment.

        Pipelined mode (pipeline_depth >= 2): `device_latency` spans
        dispatch → fetch-complete, which INCLUDES time the batch sat in
        the in-flight queue behind earlier unfetched batches — it is the
        pipeline residence time, not pure device time. The per-batch
        `fetch_latency` (D2H + resolve only) is reported alongside for
        the decomposition."""
        snap = dict(self.stats)
        with self._lat_lock:
            qlat = np.asarray(self._queue_lat, np.float64)
            dlat = np.asarray(self._device_lat, np.float64)
            flat = np.asarray(self._fetch_lat, np.float64)
        for name, arr in (("queue", qlat), ("device", dlat),
                          ("fetch", flat)):
            if arr.size:
                snap[f"{name}_latency_ms_p50"] = float(
                    np.percentile(arr, 50) * 1e3
                )
                snap[f"{name}_latency_ms_p99"] = float(
                    np.percentile(arr, 99) * 1e3
                )
            else:
                snap[f"{name}_latency_ms_p50"] = None
                snap[f"{name}_latency_ms_p99"] = None
        return snap


# -- TCP front-end --------------------------------------------------------
#
# Wire format (both directions): 4-byte big-endian length, then a JSON
# header; requests append the raw uint8 frame bytes after the header.
# Request header: {"speed_kmh": float, "height": H, "width": W}.
# Response: {"waypoints": [[x,y],...], "speed": s, "speed_seq": [...],
#            "expert_weights": [...]} (or {"error": msg}).


def _recv_exact(sock, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed")
        buf += chunk
    return buf


def _send_msg(sock, header: dict, payload: bytes = b""):
    head = json.dumps(header).encode()
    sock.sendall(struct.pack(">I", len(head)) + head + payload)


def _recv_msg(sock) -> Tuple[dict, socket.socket]:
    (hlen,) = struct.unpack(">I", _recv_exact(sock, 4))
    if hlen > MAX_HEADER_BYTES:
        raise ConnectionError(f"header length {hlen} exceeds cap")
    header = json.loads(_recv_exact(sock, hlen))
    return header, sock


class _Handler(socketserver.BaseRequestHandler):
    def handle(self):
        server: "TCPServer" = self.server  # type: ignore[assignment]
        sock = self.request
        try:
            while True:
                try:
                    header, _ = _recv_msg(sock)
                except ConnectionError:
                    return
                if header.get("op") == "stats":
                    _send_msg(sock, {"stats": server.batcher.stats_snapshot(),
                                     "buckets": server.batcher.buckets})
                    continue
                # Consume the declared payload BEFORE any error reply —
                # replying with bytes still on the wire would desync the
                # length-prefixed stream for every later request. Bound the
                # dims so a bogus header can't force a multi-GB recv.
                try:
                    h, w = int(header.get("height", 0)), int(header.get("width", 0))
                except (TypeError, ValueError):
                    h = w = 0
                if not (0 < h <= 8192 and 0 < w <= 8192):
                    _send_msg(sock, {"error": f"bad frame dims {h}x{w}"})
                    return  # cannot know the payload length — drop the conn
                payload = _recv_exact(sock, h * w * 3)
                try:
                    frame = np.frombuffer(payload, np.uint8).reshape(h, w, 3)
                    out = server.batcher.infer(
                        frame, float(header.get("speed_kmh", 0.0))
                    )
                    _send_msg(sock, {
                        k: np.asarray(v).tolist() for k, v in out.items()
                    })
                except Exception as e:
                    _send_msg(sock, {"error": str(e)})
        except (BrokenPipeError, ConnectionResetError):
            return


class TCPServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True

    def __init__(self, addr, batcher: BatchingServer):
        super().__init__(addr, _Handler)
        self.batcher = batcher


def serve_tcp(
    batcher: BatchingServer, host: str = "127.0.0.1", port: int = 0
) -> TCPServer:
    """Start the threaded TCP front-end; returns the server (its
    `server_address` carries the bound port). Call `shutdown()` to stop."""
    srv = TCPServer((host, port), batcher)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    return srv


class Client:
    """Minimal blocking client for the TCP front-end."""

    def __init__(self, host: str, port: int):
        self._sock = socket.create_connection((host, port))
        self._lock = threading.Lock()

    def infer(self, frame_u8: np.ndarray, speed_kmh: float) -> Dict:
        frame = np.ascontiguousarray(frame_u8, np.uint8)
        h, w = frame.shape[:2]
        with self._lock:
            _send_msg(
                self._sock,
                {"speed_kmh": float(speed_kmh), "height": h, "width": w},
                frame.tobytes(),
            )
            out, _ = _recv_msg(self._sock)
        if "error" in out:
            raise RuntimeError(out["error"])
        return {k: np.asarray(v) for k, v in out.items()}

    def stats(self) -> Dict:
        """Server-side batching counters ({requests, batches, rows_padded,
        max_batch_seen}) + the bucket ladder."""
        with self._lock:
            _send_msg(self._sock, {"op": "stats"})
            out, _ = _recv_msg(self._sock)
        return out

    def close(self):
        self._sock.close()
