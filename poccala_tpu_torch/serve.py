"""Batched decode serving: a double-buffered request pipeline (the
port's own copy of ``poccala_tpu/serve.py``; framework-free, it only
calls the decoder's ``decode_dispatch`` / ``decode_collect`` and the
``stream_*`` methods).

The reference's serving story is a synchronous loop — record a window,
run VAD, decode it, print, repeat (``Decoder.main``,
``Decoder.py:190-218``); every stage waits for every other stage.  On an
accelerator that serializes host work (WAV load, frontend padding,
id→word mapping) with device work (scoring + Viterbi scan), leaving the
chip idle between batches.

:class:`DecodeService` queues requests, micro-batches them and decodes
them through the device decoder's ``decode_dispatch`` /
``decode_collect`` split
(:meth:`poccala_tpu_torch.decoder.device.DeviceBeamDecoder.decode_dispatch`).
CUDA launches are asynchronous — dispatch returns as soon as the kernels
are enqueued on the stream — so while batch *k* executes on device, the
service pads and dispatches batch *k+1* and only then blocks on batch
*k*'s results (collect copies the n-best arrays to the host):
classic double buffering, one batch of latency for full host/device
overlap.  Batch filling is **adaptive**: while a batch is in flight,
the gather window extends to the (EMA-estimated) device completion
time — waiting then is free, and every request gathered replaces a
dead padded slot, so effective capacity stays near the saturated rate
even at low offered load (``benchmarks/serve_bench.json``).

Shapes are kept few: batch size is fixed (short batches are padded with
dead utterances, ``n_frames = 0``) and frame counts are rounded up to
``frame_bucket`` multiples, so a long-running service sees at most
``max_frames / frame_bucket`` shapes, not one per request.
"""

from __future__ import annotations

import queue
import threading
import time

from concurrent.futures import Future
from dataclasses import dataclass, field

import numpy as np


@dataclass
class _Call:
    """A unit of stream work executed inline by the service worker
    (serialized with batch dispatches on the one device pipeline)."""

    fn: object
    fut: Future | None = None

    def run(self):
        try:
            self.fn()
        except Exception as e:
            if self.fut is not None and not self.fut.done():
                self.fut.set_exception(e)


@dataclass
class ServiceStats:
    """Counters exposed as :attr:`DecodeService.stats`."""

    requests: int = 0
    batches: int = 0
    stream_sessions: int = 0
    stream_chunks: int = 0
    padded_slots: int = 0      # dead utterances dispatched as padding
    padded_frames: int = 0     # frame padding beyond each request's T
    frames: int = 0            # real (valid) frames decoded
    shapes: set = field(default_factory=set)  # distinct (B, T) dispatched
    # per-request wall latency, submit -> future resolved (seconds).
    # Covers queueing + batching wait + device execution — the number a
    # client actually experiences (the reference printed one wall-clock
    # figure per window, ``Decoder.py:213-218``)
    latencies_s: list = field(default_factory=list)

    def latency_summary(self) -> dict:
        """p50/p95/p99/mean request latency + realtime throughput."""
        if not self.latencies_s:
            return {}
        arr = np.asarray(self.latencies_s)
        return {
            "n": int(arr.size),
            "p50_ms": round(float(np.percentile(arr, 50)) * 1e3, 2),
            "p95_ms": round(float(np.percentile(arr, 95)) * 1e3, 2),
            "p99_ms": round(float(np.percentile(arr, 99)) * 1e3, 2),
            "mean_ms": round(float(arr.mean()) * 1e3, 2),
            "max_ms": round(float(arr.max()) * 1e3, 2),
        }


class DecodeService:
    """Double-buffered micro-batching front door for a
    :class:`~poccala_tpu_torch.decoder.device.DeviceBeamDecoder`.

    :param decoder: a device-tier decoder (anything with
        ``decode_dispatch``/``decode_collect``)
    :param batch_size: fixed micro-batch width ``B``
    :param frame_bucket: frame counts are padded up to multiples of
        this, bounding the number of compiled programs
    :param max_wait_s: after the first request of a batch arrives, wait
        at most this long for the batch to fill before dispatching
    :param return_nbest: hypotheses returned per request
    :param mesh: passed through to the decoder's ``decode_dispatch``
        (distributed serving in the JAX package; the port's decoder
        accepts only ``None``)

    Use as a context manager, or call :meth:`close` explicitly::

        with DecodeService(dec, batch_size=8) as svc:
            futs = [svc.submit(f) for f in feature_arrays]
            results = [f.result() for f in futs]
    """

    def __init__(self, decoder, batch_size: int = 8,
                 frame_bucket: int = 128, max_wait_s: float = 0.005,
                 return_nbest: int = 1, mesh=None,
                 gather_cap_s: float = 0.25):
        if batch_size < 1:
            raise ValueError("batch_size must be >= 1")
        if frame_bucket < 1:
            raise ValueError("frame_bucket must be >= 1")
        self.decoder = decoder
        self.batch_size = int(batch_size)
        self.frame_bucket = int(frame_bucket)
        self.max_wait_s = float(max_wait_s)
        self.return_nbest = int(return_nbest)
        self.mesh = mesh
        self.stats = ServiceStats()
        # EMA of device batch time, learned online; drives the adaptive
        # gather window (fill the next batch while the current one runs).
        # The very first collect is excluded (it includes JIT compile —
        # minutes for large graphs — and would peg the window for ~15
        # batches of 0.7-decay), and the window is hard-capped at
        # ``gather_cap_s`` so any compile-inflated sample (e.g. a new
        # frame-bucket shape mid-run) bounds the extra client latency
        # instead of multiplying it.
        self._ema_batch_s = 0.0
        self._ema_primed = False
        self.gather_cap_s = float(gather_cap_s)
        self._q: queue.Queue = queue.Queue()
        self._closed = False
        self._lock = threading.Lock()  # serializes submit vs close
        self._worker = threading.Thread(
            target=self._loop, name="poccala-decode-service", daemon=True)
        self._worker.start()

    # ------------------------------------------------------------------
    # client API
    # ------------------------------------------------------------------

    def submit(self, feats, n_frames: int | None = None) -> Future:
        """Enqueue one utterance's features ``[T, D]`` (float32; VAD
        already applied, as in ``cmd_decode``).  Returns a
        :class:`~concurrent.futures.Future` resolving to the n-best
        :class:`~poccala_tpu_torch.decoder.beam.Hypothesis` list."""
        feats = np.asarray(feats, np.float32)
        if feats.ndim != 2:
            raise ValueError(f"expected [T, D] features, got {feats.shape}")
        n = int(n_frames) if n_frames is not None else feats.shape[0]
        fut: Future = Future()
        # the closed-check and the enqueue must be atomic vs close():
        # otherwise submit can pass the check, close() drains + joins,
        # and the late put leaves a future nothing will ever resolve
        with self._lock:
            if self._closed:
                raise RuntimeError("DecodeService is closed")
            self._q.put((feats, n, fut, time.monotonic()))
        return fut

    def open_stream(self, chunk_frames: int = 25,
                    max_frames: int = 4096,
                    batch: int = 1) -> "ServiceStream":
        """Start a chunked (live-audio) decode session multiplexed onto
        this service's worker/device (the reference's record→decode
        serving intent, ``Decoder.py:190-218``, without buffering the
        whole utterance).  Feed ``[Tc, D]`` feature chunks as audio
        arrives; call :meth:`ServiceStream.result` at any point for the
        current hypotheses (partial results), and after the last chunk
        for the final ones — only the last chunk's advance plus the
        n-best finalize remain on the critical path, not the whole
        utterance's decode.

        :param chunk_frames: fixed device chunk length — feeds are
            re-buffered to this size (bounds compiled program count);
            a final partial chunk is padded and masked
        :param max_frames: session capacity (traceback table size)
        :param batch: number of lockstep streams — the Viterbi carries
            stack and every chunk advances all of them in ONE device
            program (e.g. a multichannel capture); feed ``[B, Tc, D]``
            and result() returns per-stream n-best lists
        """
        with self._lock:
            if self._closed:
                raise RuntimeError("DecodeService is closed")
        return ServiceStream(self, int(chunk_frames), int(max_frames),
                             batch=int(batch))

    def decode_many(self, feats_list, n_frames=None):
        """Pipelined batch convenience: submit everything, gather in
        order.  Equivalent to per-utterance ``decode_batch`` results."""
        if n_frames is None:
            n_frames = [None] * len(feats_list)
        futs = [self.submit(f, n) for f, n in zip(feats_list, n_frames)]
        return [f.result() for f in futs]

    def close(self, timeout: float | None = 30.0):
        """Drain the queue, resolve all futures, stop the worker."""
        with self._lock:
            already = self._closed
            self._closed = True
        if not already:
            self._q.put(None)  # wake the worker
            self._worker.join(timeout=timeout)
        # defensive: fail any straggler requests still queued (e.g. the
        # worker died on an exception) instead of hanging their clients
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is None:
                continue
            fut = item.fut if isinstance(item, _Call) else item[2]
            if fut is not None and not fut.done():
                fut.set_exception(
                    RuntimeError("DecodeService closed before decode"))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------------------
    # worker
    # ------------------------------------------------------------------

    def _gather_batch(self, block: bool, until: float | None = None):
        """Collect up to ``batch_size`` requests.  When ``block``, wait
        indefinitely for the first one; with ``until`` (a monotonic
        deadline), wait for the first request up to that instant —
        used while a batch is in flight, when waiting costs nothing
        (the device is busy anyway); otherwise return ``[]`` if the
        queue is momentarily empty (the caller then resolves the
        in-flight batch instead of holding its futures hostage).  After
        the first request, fill for ``max_wait_s`` or until ``until``,
        whichever is later.  ``None`` items are shutdown wake-ups, not
        requests."""
        reqs = []
        while True:  # first request (stream work executes inline)
            try:
                if block:
                    item = self._q.get()
                elif until is not None and not self._closed:
                    t = until - time.monotonic()
                    item = self._q.get(timeout=t) if t > 0 \
                        else self._q.get_nowait()
                else:
                    item = self._q.get_nowait()
            except queue.Empty:
                return reqs
            if item is None:
                return reqs
            if isinstance(item, _Call):
                item.run()
                continue
            reqs.append(item)
            break
        deadline = time.monotonic() + self.max_wait_s
        if until is not None:
            deadline = max(deadline, until)
        while len(reqs) < self.batch_size:
            remain = deadline - time.monotonic()
            try:
                item = self._q.get(
                    timeout=max(remain, 0.0) if not self._closed else 0.0)
            except queue.Empty:
                break
            if item is None:
                break
            if isinstance(item, _Call):
                item.run()
                continue
            reqs.append(item)
        return reqs

    def _dispatch(self, reqs):
        """Pad to the fixed (B, bucketed-T) shape and enqueue on device."""
        b = self.batch_size
        t_max = max(r[0].shape[0] for r in reqs)
        t_pad = max(self.frame_bucket,
                    -(-t_max // self.frame_bucket) * self.frame_bucket)
        d = reqs[0][0].shape[1]
        feats = np.zeros((b, t_pad, d), np.float32)
        nf = np.zeros((b,), np.int32)
        for i, (f, n, _, _) in enumerate(reqs):
            feats[i, : f.shape[0]] = f
            nf[i] = n
        st = self.stats
        st.requests += len(reqs)
        st.batches += 1
        st.padded_slots += b - len(reqs)
        st.frames += int(nf.sum())
        st.padded_frames += int(len(reqs) * t_pad - sum(
            r[0].shape[0] for r in reqs))
        st.shapes.add((b, t_pad))
        return self.decoder.decode_dispatch(
            feats, nf, return_nbest=self.return_nbest, mesh=self.mesh)

    def _resolve(self, pending):
        handle, reqs, t_disp = pending
        try:
            outs = self.decoder.decode_collect(handle)
            now = time.monotonic()
            # dispatch -> results-fetched is the adaptive gather
            # window's estimate of device busy time (slight
            # overestimate: includes host id->word; self-correcting)
            busy = now - t_disp
            if not self._ema_primed:
                self._ema_primed = True  # first sample = compile; skip
            else:
                self._ema_batch_s = (
                    busy if self._ema_batch_s == 0.0
                    else 0.7 * self._ema_batch_s + 0.3 * busy)
            for (_, _, fut, t_sub), hyps in zip(reqs, outs):
                self.stats.latencies_s.append(now - t_sub)
                fut.set_result(hyps)
        except Exception as e:  # pragma: no cover - defensive
            for _, _, fut, _ in reqs:
                if not fut.done():
                    fut.set_exception(e)

    def _loop(self):
        pending = None  # (handle, reqs) executing on device
        while True:
            # only block indefinitely for new work when nothing is in
            # flight.  With a batch pending, gather until the device is
            # (estimated) free: dispatching the next batch any earlier
            # gains nothing — the chip is busy — while every extra
            # request gathered replaces a dead padded slot.  Without
            # this, low offered load degenerates to ~1-request batches
            # whose padding wastes (B-1)/B of device capacity and the
            # queue backs up far below saturated throughput (measured:
            # p99 3.0 s at 0.3x load, benchmarks/serve_bench.json r04)
            until = None
            if pending is not None:
                until = pending[2] + min(0.9 * self._ema_batch_s,
                                         self.gather_cap_s)
            reqs = self._gather_batch(block=pending is None, until=until)
            nxt = None
            if reqs:
                try:
                    nxt = (self._dispatch(reqs), reqs, time.monotonic())
                except Exception as e:
                    for _, _, fut, _ in reqs:
                        fut.set_exception(e)
            # collect the PREVIOUS batch only after the next one is
            # already on the device queue — the double buffer
            if pending is not None:
                self._resolve(pending)
            pending = nxt
            if pending is None and self._closed and self._q.empty():
                break
        if pending is not None:  # pragma: no cover - race at shutdown
            self._resolve(pending)


class ServiceStream:
    """One chunked decode session on a :class:`DecodeService`.

    Wraps the device decoder's online API
    (:meth:`~poccala_tpu_torch.decoder.device.DeviceBeamDecoder.stream_init` /
    ``stream_feed`` / ``stream_result``): the Viterbi carry and the
    traceback lattice persist across chunks, and a chunked decode equals
    the one-shot decode of the concatenated features exactly
    (``tests/test_streaming_decode.py``).  All device work runs on the
    service worker thread, serialized with batch dispatches; feed and
    result are safe to call from one client thread.
    """

    def __init__(self, svc: DecodeService, chunk_frames: int,
                 max_frames: int, batch: int = 1):
        if chunk_frames < 1:
            raise ValueError("chunk_frames must be >= 1")
        if batch < 1:
            raise ValueError("batch must be >= 1")
        self.svc = svc
        self.chunk_frames = chunk_frames
        self.batch = batch
        self._st = svc.decoder.stream_init(batch=batch,
                                           max_frames=max_frames)
        self._buf: list[np.ndarray] = []
        self._buffered = 0
        self._closed = False
        # first error raised by the session's device work (worker
        # thread); surfaced on the next feed()/result() so a failed
        # chunk can never silently truncate a transcript
        self._err: Exception | None = None
        svc.stats.stream_sessions += 1

    # ------------------------------------------------------------------
    def feed(self, feats) -> None:
        """Append feature frames — ``[Tc, D]`` (or ``[B, Tc, D]`` for a
        lockstep batched stream), any Tc; full ``chunk_frames`` chunks
        are dispatched to the device as they fill (asynchronously —
        this returns immediately)."""
        if self._closed:
            raise RuntimeError("stream is closed")
        if self._err is not None:
            raise RuntimeError(
                "stream failed on an earlier chunk") from self._err
        feats = np.asarray(feats, np.float32)
        if self.batch == 1 and feats.ndim == 2:
            feats = feats[None]
        if feats.ndim != 3 or feats.shape[0] != self.batch:
            raise ValueError(
                f"expected [{self.batch}, T, D] chunk, got {feats.shape}")
        self._buf.append(feats)
        self._buffered += feats.shape[1]
        while self._buffered >= self.chunk_frames:
            flat = np.concatenate(self._buf, axis=1)
            chunk, rest = flat[:, : self.chunk_frames], \
                flat[:, self.chunk_frames:]
            self._buf = [rest] if rest.shape[1] else []
            self._buffered = rest.shape[1]
            self._enqueue_chunk(chunk, self.chunk_frames)

    def _enqueue_chunk(self, chunk: np.ndarray, n_valid: int) -> None:
        st, svc = self._st, self.svc
        b = self.batch
        if chunk.shape[1] < self.chunk_frames:  # padded final partial
            chunk = np.pad(chunk, ((0, 0),
                                   (0, self.chunk_frames - chunk.shape[1]),
                                   (0, 0)))

        def run():
            try:
                svc.decoder.stream_feed(
                    st, chunk, n_valid=np.full((b,), n_valid, np.int32))
            except Exception as e:
                if self._err is None:
                    self._err = e
                raise
            svc.stats.stream_chunks += 1
            svc.stats.frames += n_valid * b

        with svc._lock:
            if svc._closed:
                raise RuntimeError("DecodeService is closed")
            svc._q.put(_Call(run))

    def result(self, return_nbest: int = 1) -> Future:
        """Current n-best (partial mid-stream, final after the last
        feed).  Flushes any buffered partial chunk first.  Returns a
        Future resolving to the hypothesis list (``batch == 1``) or the
        per-stream list of hypothesis lists."""
        if self._buffered:
            flat = np.concatenate(self._buf, axis=1)
            self._buf, self._buffered = [], 0
            self._enqueue_chunk(flat, flat.shape[1])
        fut: Future = Future()
        st, svc = self._st, self.svc

        def run():
            if self._err is not None:
                fut.set_exception(RuntimeError(
                    "stream failed on an earlier chunk: "
                    f"{self._err!r}"))
                return
            hyps = svc.decoder.stream_result(st, return_nbest=return_nbest)
            if not fut.done():
                fut.set_result(hyps[0] if self.batch == 1 else hyps)

        with svc._lock:
            if svc._closed:
                raise RuntimeError("DecodeService is closed")
            svc._q.put(_Call(run, fut))
        return fut

    def close(self) -> None:
        self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
