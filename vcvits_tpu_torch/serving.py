"""Concurrent serving: the micro-batching daemon, its stream pool and HTTP
front end, on the GPU.

Counterpart of vcvits_tpu/serving.py:

* clients `submit()` prepared sources concurrently (thread-safe; each call
  returns a Future of the converted 48 kHz waveform);
* one dispatcher thread admits requests from a queue and micro-batches
  them within a latency window (the first request opens it; it closes
  after `window_ms` or at `max_batch`); requests whose `noise_scale`
  differs from the batch head's wait for a later batch;
* a batch pads every source to the longest in it and its size to the next
  power of two (padding rows have length 1), and runs as one
  `SynthesizerSVC.infer` call (K2 for the flow reverse and K1 for the
  decoder's MRF, each one launch per coupling or (block, dilation) for the
  whole batch), the per-row lengths masking the padding;
* the audio is cast to the wire format on the device (f32, f16, i16 or
  8-bit mu-law), copied without blocking into pinned host memory, and a
  resolver thread waits for that copy's CUDA event, slices every row to
  its valid length and resolves the futures while the dispatcher is
  already running the next batch;
* p50/p95 latency and batch sizes are tracked (`stats`), and so are each
  request's wait in the queue (from `submit` to its batch's admission) and
  the source samples each batch carried: valid (the requests' own) and
  padded (the rest of rows x padded length).

Program spans (utils/profiling.py), each with the batch's number: the
dispatcher's "vcvits.serve.gather" (the wait for a head and the latency
window), "vcvits.serve.pad" (the batch padded on the host) and
"vcvits.serve.infer" (each replica's upload of its rows, its `infer`,
whose model spans it encloses, the wire cast and the copy started); the
resolver's "vcvits.serve.resolve_wait" (the copy's event) and
"vcvits.serve.resolve" (the rows sliced and the futures resolved).

Noise: a batch draws its eps from one `torch.Generator` on the device,
seeded with the batch head's `rng_seed` (JAX keys the batch on the head
too). A request that rides alone gives exactly
`VoiceConverter.convert_array(..., rng_seed=seed)`'s output; at
`noise_scale=0` a row of a batch of equal lengths equals its solo
conversion, and in a batch of mixed lengths every row keeps its length and
the longest row its values.

Data parallelism (`devices=[...]`, JAX's `mesh` with a data axis): one
replica of the generator per device, its weights copied once; a batch is
padded to max(next power of two, replicas) rows, as JAX pads it, its eps
drawn once for the whole batch on the first device (so each row gets
what one replica would give it), and its rows split contiguously over
the replicas, each running on its own thread and CUDA stream; the rows
come back in order. A device may be named twice (two replicas on one
card, or on the CPU).
"""

from __future__ import annotations

import contextlib
import copy
import itertools
import queue
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from vcvits_tpu_torch.infer import VoiceConverter
from vcvits_tpu_torch.models.synthesizer import DEFAULT_LENGTH_SCALE
from vcvits_tpu_torch.streaming import StreamingConverter
from vcvits_tpu_torch.utils.device import resolve_device
from vcvits_tpu_torch.utils.profiling import span

HUBERT_DOWNSAMPLE = 320  # source samples per content frame (the pitch cadence)


@dataclass
class _Request:
    wav16k: np.ndarray          # alignment-unit padded source
    pitch: np.ndarray
    true_len: int
    speaker_id: int
    noise_scale: float
    rng_seed: int
    future: Future = field(default_factory=Future)
    t_submit: float = field(default_factory=time.perf_counter)


def _next_batch_size(n: int, max_batch: int) -> int:
    """Quantize to powers of two (a bounded set of batch shapes)."""
    b = 1
    while b < n:
        b *= 2
    return min(b, max_batch)


_MU = 255.0  # G.711-style mu-law companding constant


def _mulaw_encode(x):
    """[-1, 1] float -> uint8 mu-law code, for a numpy array or a torch
    tensor (on its device). 8-bit log-companded: the error scales with the
    amplitude (about 0.022 |x|). 255 levels, code 127 exactly zero,
    sign-symmetric."""
    if torch.is_tensor(x):
        x = torch.clamp(x, -1.0, 1.0)
        y = torch.sign(x) * torch.log1p(_MU * torch.abs(x)) / float(np.log1p(_MU))
        return torch.round(y * 127.0 + 127.0).to(torch.uint8)
    x = np.clip(x, -1.0, 1.0)
    y = np.sign(x) * np.log1p(_MU * np.abs(x)) / np.log1p(_MU)
    return np.round(y * 127.0 + 127.0).astype(np.uint8)


def _mulaw_decode(q):
    """uint8 mu-law code -> float32 in [-1, 1], numpy or torch."""
    if torch.is_tensor(q):
        y = (q.to(torch.float32) - 127.0) / 127.0
        return torch.sign(y) * (torch.pow(1.0 + _MU, torch.abs(y)) - 1.0) / _MU
    y = (q.astype(np.float32) - 127.0) / 127.0
    return (np.sign(y) * (np.power(1.0 + _MU, np.abs(y)) - 1.0) / _MU).astype(np.float32)


class ServingDaemon:
    """Queueing micro-batch loop over a `VoiceConverter`.

    >>> daemon = ServingDaemon(vc, max_batch=16, window_ms=25)
    >>> fut = daemon.submit(wav16k, pitch, true_len, speaker_id=3)
    >>> out48k = fut.result()
    >>> daemon.close()
    """

    def __init__(self, vc: VoiceConverter, max_batch: int = 16, window_ms: float = 25.0,
                 queue_size: int = 256, transfer: str = "f32",
                 devices: Optional[List] = None):
        """transfer: the wire format of the device->host audio and, for "i16"
        and "mulaw", of the host->device sources. "f32" is exact; "f16"
        halves and "i16" quarters the output copy (PCM-16 precision);
        "mulaw" keeps i16 sources and ships 8-bit mu-law codes (error
        about 0.022 |x|). devices: one replica per entry (a power of two
        of them, at most max_batch; see the module docstring); None runs
        the converter's own generator alone."""
        if transfer not in ("f32", "f16", "i16", "mulaw"):
            raise ValueError(f"transfer must be f32|f16|i16|mulaw, got {transfer!r}")
        if devices is not None:
            n = len(devices)
            if n < 1 or n & (n - 1):
                raise ValueError(f"the replica count must be a power of two, got {n}")
            if max_batch < n:
                raise ValueError(f"max_batch {max_batch} < {n} replicas: every batch must "
                                 "split evenly")
        self.vc = vc
        self._replicas = self._make_replicas(vc, devices)
        self._pool = (ThreadPoolExecutor(len(self._replicas), thread_name_prefix="replica")
                      if len(self._replicas) > 1 else None)
        self.max_batch = int(max_batch)
        self.window_ms = float(window_ms)
        self.transfer = transfer
        self._q: "queue.Queue[Optional[_Request]]" = queue.Queue(maxsize=queue_size)
        self._deferred: List[_Request] = []  # noise_scale-mismatched leftovers
        self._lock = threading.Lock()
        self._latencies: List[float] = []
        self._batch_sizes: List[int] = []
        self._queue_waits: List[float] = []
        self._valid_samples = 0
        self._padded_samples = 0
        self._batch_ids = itertools.count()
        self._closed = False
        # the resolver waits for each batch's device->host copy and resolves
        # its futures off the dispatcher thread, so the next batch is
        # gathered and launched while the previous one's audio is in flight
        self._resolve_q: "queue.Queue" = queue.Queue(maxsize=2)
        self._resolver = threading.Thread(target=self._resolve_loop, daemon=True)
        self._resolver.start()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    # ------------------------------------------------------------ client API
    def submit(self, wav16k: np.ndarray, pitch: np.ndarray, true_len: int, speaker_id: int,
               noise_scale: float = 1.0, rng_seed: int = 0) -> Future:
        """Enqueue a prepared source (see VoiceConverter.prepare_source).
        Returns a Future resolving to the converted 48 kHz waveform."""
        if self._closed:
            raise RuntimeError("daemon is closed")
        req = _Request(np.asarray(wav16k, np.float32), np.asarray(pitch), int(true_len),
                       int(speaker_id), float(noise_scale), int(rng_seed))
        self._q.put(req)
        return req.future

    def submit_file(self, path: str, speaker_id: int, pitch_shift: int = 0,
                    noise_scale: float = 1.0, rng_seed: int = 0) -> Future:
        """Host-prepare (read, resample, pYIN: in the CALLER's thread, so
        concurrent clients prepare in parallel), then enqueue."""
        wav, true_len, pitch = self.vc.prepare_source(path, pitch_shift)
        return self.submit(wav, pitch, true_len, speaker_id, noise_scale, rng_seed)

    def convert_file(self, path: str, speaker_id: int, **kw) -> np.ndarray:
        """Blocking one-call client."""
        return self.submit_file(path, speaker_id, **kw).result()

    # ------------------------------------------------------------ statistics
    def stats(self) -> Dict[str, float]:
        with self._lock:
            lat = np.asarray(self._latencies, np.float64)
            bs = np.asarray(self._batch_sizes, np.float64)
            wait = np.asarray(self._queue_waits, np.float64)
            samples = {"valid_samples": self._valid_samples,
                       "padded_samples": self._padded_samples}
        if not len(lat):
            return {"requests": 0, **samples}
        return {
            "requests": int(len(lat)),
            "batches": int(len(bs)),
            "mean_batch": round(float(bs.mean()), 2),
            "latency_p50_ms": round(float(np.percentile(lat, 50)) * 1e3, 1),
            "latency_p95_ms": round(float(np.percentile(lat, 95)) * 1e3, 1),
            "latency_max_ms": round(float(lat.max()) * 1e3, 1),
            "queue_wait_p50_ms": round(float(np.percentile(wait, 50)) * 1e3, 1),
            "queue_wait_p95_ms": round(float(np.percentile(wait, 95)) * 1e3, 1),
            **samples,
        }

    def reset_stats(self) -> None:
        with self._lock:
            self._latencies.clear()
            self._batch_sizes.clear()
            self._queue_waits.clear()
            self._valid_samples = self._padded_samples = 0

    def close(self, timeout: float = 30.0) -> None:
        if not self._closed:
            self._closed = True
            self._q.put(None)
            self._thread.join(timeout=timeout)
            self._resolve_q.put(None)
            self._resolver.join(timeout=timeout)
            if self._pool is not None:
                self._pool.shutdown(wait=True)

    # -------------------------------------------------------------- replicas
    @staticmethod
    def _make_replicas(vc: VoiceConverter, devices) -> List[tuple]:
        """(generator, device, stream) per replica: the converter's own
        generator on its device, a copy of it elsewhere (made once)."""
        if devices is None:
            return [(vc.gen, vc.device, None)]
        out = []
        for d in devices:
            dev = resolve_device(d)
            if dev.type == "cuda" and dev.index is None:
                dev = torch.device("cuda", torch.cuda.current_device())
            same = dev == vc.device or (dev.type == vc.device.type == "cuda"
                                        and vc.device.index in (None, dev.index))
            gen = vc.gen if same and not out else copy.deepcopy(vc.gen).to(dev)
            stream = torch.cuda.Stream(device=dev) if dev.type == "cuda" else None
            out.append((gen, dev, stream))
        return out

    @property
    def devices(self) -> List[torch.device]:
        return [dev for _, dev, _ in self._replicas]

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ----------------------------------------------------------- dispatcher
    def _gather(self) -> Optional[List[_Request]]:
        """Admit one batch: the first request opens the latency window; it
        closes after window_ms or at max_batch. Requests whose noise_scale
        differs from the batch head's are deferred to a later batch."""
        batch: List[_Request] = []
        if self._deferred:
            batch.append(self._deferred.pop(0))
        else:
            head = self._q.get()
            if head is None:
                return None
            batch.append(head)
        ns = batch[0].noise_scale
        deadline = time.perf_counter() + self.window_ms / 1e3
        # absorb same-noise deferred requests first (FIFO fairness)
        i = 0
        while i < len(self._deferred) and len(batch) < self.max_batch:
            if self._deferred[i].noise_scale == ns:
                batch.append(self._deferred.pop(i))
            else:
                i += 1
        while len(batch) < self.max_batch:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            try:
                req = self._q.get(timeout=remaining)
            except queue.Empty:
                break
            if req is None:
                self._q.put(None)  # re-post shutdown for the outer loop
                break
            if req.noise_scale != ns:
                self._deferred.append(req)
                continue
            batch.append(req)
        return batch

    def _run_batch(self, wavs: np.ndarray, lens: np.ndarray, pitches: np.ndarray,
                   sids: np.ndarray, seed: int, noise_scale: float) -> List[tuple]:
        """The batch on the replicas: each one's contiguous rows through
        `_run_rows` on its own thread and stream, the eps of the whole
        batch drawn once on the first replica's device. Returns each
        replica's started copy (`_start_copy`), in row order."""
        n = len(self._replicas)
        if n == 1:
            gen, dev, _ = self._replicas[0]
            return [self._run_rows(gen, dev, None, wavs, lens, pitches, sids, seed,
                                   noise_scale, None)]
        eps_ready = None
        dev0 = self._replicas[0][1]
        k = wavs.shape[0] // n
        t_out = int(round(wavs.shape[1] * DEFAULT_LENGTH_SCALE))
        with torch.inference_mode():
            eps = torch.randn((wavs.shape[0], t_out, self.vc.cfg.model.inter_channels),
                              generator=torch.Generator(device=dev0).manual_seed(seed),
                              device=dev0, dtype=self.vc.gen.dtype)
            if dev0.type == "cuda":
                eps_ready = torch.cuda.Event()
                eps_ready.record()
        futures = [self._pool.submit(self._run_rows, gen, dev, stream, wavs[i * k:(i + 1) * k],
                                     lens[i * k:(i + 1) * k], pitches[i * k:(i + 1) * k],
                                     sids[i * k:(i + 1) * k], seed, noise_scale,
                                     eps[i * k:(i + 1) * k], eps_ready)
                   for i, (gen, dev, stream) in enumerate(self._replicas)]
        return [f.result() for f in futures]

    def _run_rows(self, model, dev: torch.device, stream, wavs: np.ndarray, lens: np.ndarray,
                  pitches: np.ndarray, sids: np.ndarray, seed: int, noise_scale: float,
                  eps: Optional[torch.Tensor], eps_ready=None) -> tuple:
        """One replica's rows: `infer` on [rows, pad_len] sources, each
        row's valid output length (counted in float32: a bf16 sum of more
        than 256 ones rounds) and the audio cast to the wire format on the
        device, then the copy to the host started (`_start_copy`)."""
        ctx = torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext()
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        with ctx, torch.inference_mode():
            if stream is not None and eps is not None:
                stream.wait_event(eps_ready)  # the draw, made on the dispatcher's stream
                if eps.device == dev:
                    eps.record_stream(stream)
                else:  # copied before the dispatcher may free the first device's draw
                    eps = eps.to(dev)
                    stream.synchronize()
            wav = torch.from_numpy(wavs).to(dev)
            if self.transfer in ("i16", "mulaw"):  # mulaw rides i16 sources
                wav = wav.to(torch.float32) / 32767.0
            gen = torch.Generator(device=dev).manual_seed(seed)
            o, y_mask, _ = model.infer(
                wav, torch.from_numpy(lens).to(dev), torch.from_numpy(pitches).to(dev),
                torch.from_numpy(sids).to(dev), noise_scale=noise_scale, generator=gen,
                eps=None if eps is None else eps.to(dev))
            n_valid = (y_mask.reshape(y_mask.shape[0], -1).float().sum(dim=-1)
                       .to(torch.int32) * self.vc.cfg.data.hop_length)
            o = o[:, :, 0]
            if self.transfer == "f16":
                o = o.to(torch.float16)
            elif self.transfer == "i16":
                o = torch.round(torch.clamp(o.float(), -1.0, 1.0) * 32767.0).to(torch.int16)
            elif self.transfer == "mulaw":
                o = _mulaw_encode(o.float())
            else:
                o = o.float()
            return self._start_copy(o, n_valid)

    @staticmethod
    def _start_copy(o: torch.Tensor, n_valid: torch.Tensor):
        """Start the device->host copy of a batch without waiting for it:
        (o, n_valid, event). On a CUDA device the copies go into pinned
        host tensors allocated for this batch and the event marks their
        end on the current stream; PyTorch's pinned-memory cache reuses a
        block only after its tensor is freed and the copies recorded on it
        are done, so the next batch cannot overwrite a buffer the resolver
        still holds. On the CPU there is nothing to copy (event None)."""
        if o.device.type != "cuda":
            return o, n_valid, None
        o_host = torch.empty(o.shape, dtype=o.dtype, pin_memory=True)
        nv_host = torch.empty(n_valid.shape, dtype=n_valid.dtype, pin_memory=True)
        o_host.copy_(o, non_blocking=True)
        nv_host.copy_(n_valid, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return o_host, nv_host, event

    def _resolve_loop(self) -> None:
        while True:
            item = self._resolve_q.get()
            if item is None:
                break
            bid, batch, parts = item
            try:
                with span("serve.resolve_wait", batch=bid):
                    for _, _, event in parts:
                        if event is not None:
                            event.synchronize()  # this batch's copies only, not later work
                with span("serve.resolve", batch=bid):
                    self._resolve(batch, parts)
            except Exception as e:  # noqa: BLE001 - resolve the futures, keep serving
                for r in batch:
                    if not r.future.done():
                        r.future.set_exception(e)

    def _resolve(self, batch: List[_Request], parts: List[tuple]) -> None:
        """Slice every row of a batch's copied audio to its valid length,
        count the batch, and resolve its futures."""
        o_np = np.concatenate([o.numpy() for o, _, _ in parts])
        nv = np.concatenate([n.numpy() for _, n, _ in parts])
        t_done = time.perf_counter()
        outs = []
        for row in range(len(batch)):
            out = o_np[row, : nv[row]]
            if self.transfer == "i16":
                out = out.astype(np.float32) / 32767.0
            elif self.transfer == "mulaw":
                out = _mulaw_decode(out)
            else:  # f32 and f16; a copy, so no result holds the batch buffer
                out = out.astype(np.float32)
            outs.append(out)
        # counted before any client sees its result, so stats() read after a
        # result includes that result's batch
        with self._lock:
            self._batch_sizes.append(len(batch))
            self._latencies.extend(t_done - r.t_submit for r in batch)
        for r, out in zip(batch, outs):
            r.future.set_result(out)

    def _pad(self, batch: List[_Request], bsz: int, t_admit: float):
        """The batch's sources, pitches, lengths and speakers padded to bsz
        rows of the longest source (host arrays; i16 sources on an i16 or
        mu-law wire); counts its valid and padded samples and its requests'
        queue waits."""
        i16 = self.transfer in ("i16", "mulaw")
        pad_len = max(len(r.wav16k) for r in batch)
        wavs = np.zeros((bsz, pad_len), np.int16 if i16 else np.float32)
        pitches = np.zeros((bsz, pad_len // HUBERT_DOWNSAMPLE), np.int64)
        lens = np.zeros((bsz,), np.int32)
        sids = np.zeros((bsz,), np.int64)
        for row, r in enumerate(batch):
            w = r.wav16k
            if i16:
                w = np.round(np.clip(w, -1.0, 1.0) * 32767.0).astype(np.int16)
            wavs[row, : len(w)] = w
            pitches[row, : len(r.pitch)] = r.pitch
            lens[row] = r.true_len
            sids[row] = r.speaker_id
        lens[len(batch):] = 1  # batch-pad rows: minimal valid length
        valid = sum(r.true_len for r in batch)
        with self._lock:
            self._valid_samples += valid
            self._padded_samples += bsz * pad_len - valid
            self._queue_waits.extend(t_admit - r.t_submit for r in batch)
        return wavs, lens, pitches, sids

    def _loop(self) -> None:
        dev = self._replicas[0][1]
        if dev.type == "cuda":
            torch.cuda.set_device(dev)  # this thread's launches and events on dev
        n_replicas = len(self._replicas)
        while True:
            bid = next(self._batch_ids)
            with span("serve.gather", batch=bid):
                batch = self._gather()
            if batch is None:
                break
            t_admit = time.perf_counter()
            try:
                # a power of two >= the replica count splits evenly
                bsz = max(_next_batch_size(len(batch), self.max_batch), n_replicas)
                with span("serve.pad", batch=bid):
                    arrays = self._pad(batch, bsz, t_admit)
                with span("serve.infer", batch=bid):
                    parts = self._run_batch(*arrays, batch[0].rng_seed, batch[0].noise_scale)
                # hand off to the resolver: the copy overlaps the NEXT batch's
                # gather and launches (at most 2 batches behind)
                self._resolve_q.put((bid, batch, parts))
            except Exception as e:  # noqa: BLE001 - resolve the futures, keep serving
                for r in batch:
                    if not r.future.done():
                        r.future.set_exception(e)


class StreamPool:
    """Reusable StreamingConverter sessions for /stream connections.

    Sessions are kept by the knobs that size their state (chunk and
    context seconds, incremental) and re-targeted per connection (speaker,
    noise, seed) after a reset: an incremental session's cached conv state
    and folded weights are made once. `max_sessions` bounds the sessions
    across all keys, idle ones included; an idle session of another key is
    evicted before a request is refused."""

    def __init__(self, vc: VoiceConverter, max_sessions: int = 4):
        self._cls = StreamingConverter
        self.vc = vc
        self.max_sessions = max_sessions
        self._idle: Dict[tuple, List] = {}
        self._live = 0
        self._lock = threading.Lock()

    def acquire(self, speaker_id: int, chunk_seconds: float = 2.0,
                context_seconds: float = 0.16, incremental: bool = False,
                noise_scale: float = 1.0, rng_seed: int = 0):
        """A ready session, or None when max_sessions are already in use."""
        key = (round(chunk_seconds, 6), round(context_seconds, 6), bool(incremental))
        with self._lock:
            pool = self._idle.setdefault(key, [])
            conv = pool.pop() if pool else None
            if conv is None:
                if self._live >= self.max_sessions:
                    # evict an idle session of another key, so idle sessions
                    # never starve differently-shaped requests
                    for other in self._idle.values():
                        if other:
                            other.pop()  # dropped; its device state is freed
                            self._live -= 1
                            break
                    if self._live >= self.max_sessions:
                        return None
                self._live += 1
        if conv is None:
            try:
                conv = self._cls(self.vc, speaker_id=speaker_id, chunk_seconds=chunk_seconds,
                                 context_seconds=context_seconds, incremental=incremental,
                                 noise_scale=noise_scale, rng_seed=rng_seed)
            except BaseException:
                with self._lock:
                    self._live -= 1
                raise
            conv._pool_key = key
        else:
            conv.set_speaker(speaker_id)
            conv.noise_scale = noise_scale
            conv.rng_seed = rng_seed
        return conv

    def release(self, conv) -> None:
        conv.reset()
        with self._lock:
            self._idle[conv._pool_key].append(conv)


def _quantize_noise(x: float) -> float:
    """A client's noise_scale on a 0.05 grid in [0, 2] (0.71 -> 0.7), as the
    JAX package quantizes it, so the same request gives the same output."""
    return min(max(round(float(x) * 20.0) / 20.0, 0.0), 2.0)


def _iter_request_body(handler, block: int = 32768):
    """Raw body bytes of a BaseHTTPRequestHandler request, for both
    Content-Length and Transfer-Encoding: chunked (the chunk framing is
    parsed here: the stdlib's rfile is a plain stream)."""
    te = (handler.headers.get("Transfer-Encoding") or "").lower()
    if "chunked" in te:
        while True:
            line = handler.rfile.readline(1024).strip()
            if not line:
                return
            size = int(line.split(b";")[0], 16)
            if size == 0:
                handler.rfile.readline(1024)  # trailing CRLF (no trailers)
                return
            remaining = size
            while remaining > 0:
                piece = handler.rfile.read(min(block, remaining))
                if not piece:
                    return
                remaining -= len(piece)
                yield piece
            handler.rfile.read(2)  # chunk-terminating CRLF
    else:
        remaining = int(handler.headers.get("Content-Length", 0))
        while remaining > 0:
            piece = handler.rfile.read(min(block, remaining))
            if not piece:
                return
            remaining -= len(piece)
            yield piece


def serve_http(daemon: ServingDaemon, host: str = "127.0.0.1", port: int = 8300,
               max_stream_sessions: int = 4):
    """A stdlib HTTP front end; returns the threading server (call
    serve_forever()).

    * `POST /convert?sid=N[&pitch_shift=S][&noise_scale=X]`: a wav body ->
      the converted wav (PCM_24), micro-batched through the daemon with
      every other request in flight.
    * `POST /stream?sid=N[&chunk_seconds=2.0][&context_seconds=0.16]
      [&incremental=1][&noise_scale=1.0][&seed=0][&format=i16|f32]`: raw
      mono PCM at the source rate (16 kHz) in, chunked raw PCM at 48 kHz
      out, each piece written as soon as its chunk converts while the body
      is still uploading. Sessions come from a `StreamPool`; 503 when
      `max_stream_sessions` are in use, 400 on another input rate.
    * `GET /stats`: the daemon's statistics as JSON.
    """
    import json
    import os
    import tempfile
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
    from urllib.parse import parse_qs, urlparse

    from vcvits_tpu_torch.dsp.pitch import coarse_f0, estimate_pitch
    from vcvits_tpu_torch.dsp.pitch_shift import pitch_shift as shift_semitones
    from vcvits_tpu_torch.dsp.resample import resample
    from vcvits_tpu_torch.utils.audio_io import read_wav, write_wav

    vc = daemon.vc
    stream_pool = StreamPool(vc, max_sessions=max_stream_sessions)

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"  # chunked responses for /stream
        # socket inactivity bound: a stalled client must not hold a pooled
        # /stream session (or a worker thread) forever; the read raises and
        # the finally-block recycles the session
        timeout = 600

        def do_POST(self):
            try:
                u = urlparse(self.path)
                if u.path == "/stream":
                    self._do_stream(parse_qs(u.query))
                    return
                if u.path != "/convert":
                    self.send_error(404)
                    return
                q = parse_qs(u.query)
                sid = int(q.get("sid", ["0"])[0])
                shift = int(q.get("pitch_shift", ["0"])[0])
                noise = _quantize_noise(q.get("noise_scale", ["1.0"])[0])
                body = b"".join(_iter_request_body(self))
                with tempfile.NamedTemporaryFile(suffix=".wav", delete=False) as tf:
                    tf.write(body)
                    tmp_in = tf.name
                try:
                    wav, sr = read_wav(tmp_in)
                finally:
                    os.unlink(tmp_in)
                d = vc.cfg.data
                wav = resample(wav, sr, d.source_sampling_rate)
                if shift:
                    wav = shift_semitones(wav, d.source_sampling_rate, shift)
                true_len = len(wav)
                padded = int(np.ceil(max(true_len, 1) / vc.unit) * vc.unit)
                wav = np.pad(wav, (0, padded - true_len)).astype(np.float32)
                f0 = estimate_pitch(wav, sr=d.source_sampling_rate, n_fft=d.filter_length,
                                    win_length=d.win_length, hop_length=HUBERT_DOWNSAMPLE)
                pitch = coarse_f0(f0, f0_bin=d.num_pitch)
                out = daemon.submit(wav, pitch, true_len, sid, noise_scale=noise).result()
                with tempfile.NamedTemporaryFile(suffix=".wav", delete=False) as tf:
                    tmp_out = tf.name
                try:
                    write_wav(tmp_out, out, d.target_sampling_rate, subtype="PCM_24")
                    with open(tmp_out, "rb") as fh:
                        data = fh.read()
                finally:
                    os.unlink(tmp_out)
                self.send_response(200)
                self.send_header("Content-Type", "audio/wav")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
            except Exception as e:  # noqa: BLE001 - a device error, too, is a 500
                self.send_error(500, str(e))

        def _do_stream(self, q):
            d = vc.cfg.data
            sid = int(q.get("sid", ["0"])[0])
            fmt = q.get("format", ["i16"])[0]
            if fmt not in ("i16", "f32"):
                self.send_error(400, f"unknown format {fmt!r}")
                return
            rate = int(q.get("rate", [str(d.source_sampling_rate)])[0])
            if rate != d.source_sampling_rate:
                self.send_error(400, f"stream input must be {d.source_sampling_rate} Hz "
                                     "mono PCM (resample client-side)")
                return
            conv = stream_pool.acquire(
                sid,
                chunk_seconds=float(q.get("chunk_seconds", ["2.0"])[0]),
                context_seconds=float(q.get("context_seconds", ["0.16"])[0]),
                incremental=q.get("incremental", ["0"])[0] in ("1", "true"),
                noise_scale=_quantize_noise(q.get("noise_scale", ["1.0"])[0]),
                rng_seed=int(q.get("seed", ["0"])[0]),
            )
            if conv is None:
                self.send_error(503, "all streaming sessions busy")
                return

            width = 2 if fmt == "i16" else 4

            def encode(piece: np.ndarray) -> bytes:
                if fmt == "i16":
                    return (np.clip(piece, -1.0, 1.0) * 32767.0).astype("<i2").tobytes()
                return piece.astype("<f4").tobytes()

            def write_chunk(data: bytes) -> None:
                if data:
                    self.wfile.write(f"{len(data):x}\r\n".encode())
                    self.wfile.write(data)
                    self.wfile.write(b"\r\n")

            try:
                self.send_response(200)
                self.send_header("Content-Type", "application/octet-stream")
                self.send_header("Transfer-Encoding", "chunked")
                self.send_header("X-Sample-Rate", str(d.target_sampling_rate))
                self.send_header("X-Format", fmt)
                self.end_headers()
                carry = b""
                try:
                    for body_piece in _iter_request_body(self):
                        carry += body_piece
                        usable = len(carry) // width * width
                        if not usable:
                            continue
                        samples = np.frombuffer(carry[:usable],
                                                dtype="<i2" if fmt == "i16" else "<f4")
                        carry = carry[usable:]
                        if fmt == "i16":
                            samples = samples.astype(np.float32) / 32767.0
                        for piece in conv.push(samples):
                            write_chunk(encode(piece))
                    for piece in conv.flush():
                        write_chunk(encode(piece))
                finally:
                    # back in the pool before the client sees the end of the
                    # body, so a client's next connection finds it
                    stream_pool.release(conv)
                self.wfile.write(b"0\r\n\r\n")
            except Exception:  # noqa: BLE001
                # a failure after the 200 and the chunked headers went out
                # (client hang-up, socket timeout, malformed chunk framing,
                # a converter error) cannot become a 500: its bytes would
                # corrupt the open chunked body, so drop the connection
                self.close_connection = True

        def do_GET(self):
            if self.path == "/stats":
                data = json.dumps(daemon.stats()).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
            else:
                self.send_error(404)

        def log_message(self, *a):  # quiet
            pass

    return ThreadingHTTPServer((host, port), Handler)
