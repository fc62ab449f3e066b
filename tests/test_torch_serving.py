"""The port's serving layer (vcvits_tpu_torch/serving.py, cli/serve.py) on the
CPU: micro-batching, the wire formats, the HTTP front end and the CLI.

tests/test_torch_streaming.py's tiny configuration and shared weights, the
port on the CPU. The helpers (_next_batch_size, _quantize_noise, the
mu-law codes) are bit-equal to the JAX package's. A daemon's rows match
the port's own convert_array (itself held to JAX's at 1e-4 in
tests/test_torch_synthesizer.py) to atol 1e-5, except: a lone request at
any noise scale matches it exactly (same generator seed, same draw); in a
mixed-length batch only the longest row is held to its values (the others
to their lengths); f16 and i16 wires stay within 2e-3 and mu-law within
0.0225 |x| + 3e-3 (JAX's bounds, tests/test_serving.py).
"""

import contextlib
import http.client
import json
import socket
import threading
import time
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_streaming import CFG, HUBERT, converters  # noqa: F401 (fixture)
from vcvits_tpu import serving as jax_serving
from vcvits_tpu_torch import serving
from vcvits_tpu_torch.dsp.pitch import coarse_f0, estimate_pitch
from vcvits_tpu_torch.serving import (
    ServingDaemon, StreamPool, _mulaw_decode, _mulaw_encode, _next_batch_size, _quantize_noise,
    serve_http)
from vcvits_tpu_torch.streaming import StreamingConverter
from vcvits_tpu_torch.utils.audio_io import read_wav, write_wav

torch.set_num_threads(1)
SR = 16000
TIMEOUT = 120


def _prep(vc, freq, seconds=0.4):
    """A prepared source: (unit-padded 16 kHz wav, coarse pitch, true length)."""
    t = np.arange(int(SR * seconds)) / SR
    wav = (0.4 * np.sin(2 * np.pi * freq * t)).astype(np.float32)
    true_len = len(wav)
    wav = np.pad(wav, (0, int(np.ceil(true_len / vc.unit) * vc.unit) - true_len))
    d = vc.cfg.data
    f0 = estimate_pitch(wav, sr=SR, n_fft=d.filter_length, win_length=d.win_length,
                        hop_length=320)
    return wav, coarse_f0(f0, f0_bin=d.num_pitch), true_len


@pytest.fixture(scope="module")
def vc(converters):  # noqa: F811
    return converters[1]


@contextlib.contextmanager
def _http(daemon, **kw):
    server = serve_http(daemon, host="127.0.0.1", port=0, **kw)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield server.server_address[1]
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)


def test_helpers_match_jax():
    for n in range(1, 41):
        for m in (1, 4, 16):
            assert _next_batch_size(n, m) == jax_serving._next_batch_size(n, m)
    for x in list(np.linspace(-1, 3, 4001)) + [0.71, "0.33", 0.7200001, -5.0, 99.0]:
        assert _quantize_noise(x) == jax_serving._quantize_noise(x)
    assert _quantize_noise(0.71) == 0.7


def test_mulaw_codes_match_jax():
    rng = np.random.default_rng(0)
    x = np.concatenate([np.linspace(-1.2, 1.2, 48001), rng.uniform(-1, 1, 100000),
                        rng.standard_normal(20000) * 1e-3]).astype(np.float32)
    ref_np = jax_serving._mulaw_encode(x, np)
    ref_jnp = np.asarray(jax_serving._mulaw_encode(jnp.asarray(x), jnp))
    got_np = _mulaw_encode(x)
    got_t = _mulaw_encode(torch.from_numpy(x))
    assert got_np.dtype == np.uint8 and got_t.dtype == torch.uint8
    np.testing.assert_array_equal(got_np, ref_np)
    np.testing.assert_array_equal(got_t.numpy(), ref_jnp)
    codes = np.arange(256, dtype=np.uint8)
    np.testing.assert_array_equal(_mulaw_decode(codes), jax_serving._mulaw_decode(codes, np))
    np.testing.assert_allclose(_mulaw_decode(torch.from_numpy(codes)).numpy(),
                               jax_serving._mulaw_decode(codes, np), atol=1e-7, rtol=0)
    y = _mulaw_decode(got_np[:48001])
    xc = np.clip(x[:48001], -1, 1)
    assert np.all(np.abs(y - xc) <= 0.0225 * np.abs(xc) + 2e-4)


def test_daemon_matches_convert_array(vc, converters):  # noqa: F811
    jvc = converters[0]
    wav, pitch, tl = _prep(vc, 220.0)
    direct = vc.convert_array(wav, pitch, 1, tl, noise_scale=0.0)
    with ServingDaemon(vc, max_batch=4, window_ms=5) as daemon:
        out = daemon.submit(wav, pitch, tl, 1, noise_scale=0.0).result(timeout=TIMEOUT)
        assert daemon.stats()["requests"] == 1  # counted before the result is handed out
    assert out.dtype == np.float32 and out.shape == direct.shape
    np.testing.assert_allclose(out, direct, atol=1e-5, rtol=0)
    np.testing.assert_allclose(out, jvc.convert_array(wav, pitch, 1, tl, noise_scale=0.0),
                               atol=1e-4, rtol=0)


def test_lone_request_with_noise_equals_convert_array(vc):
    wav, pitch, tl = _prep(vc, 277.0)
    direct = vc.convert_array(wav, pitch, 2, tl, noise_scale=1.0, rng_seed=7)
    with ServingDaemon(vc, max_batch=4, window_ms=5) as daemon:
        out = daemon.submit(wav, pitch, tl, 2, noise_scale=1.0, rng_seed=7).result(
            timeout=TIMEOUT)
        other = daemon.submit(wav, pitch, tl, 2, noise_scale=1.0, rng_seed=8).result(
            timeout=TIMEOUT)
    np.testing.assert_array_equal(out, direct)
    assert not np.array_equal(other, direct)


def test_concurrent_clients_all_answered_and_batched(vc):
    reqs = [_prep(vc, f) for f in (220.0, 277.0, 330.0, 392.0)]
    directs = [vc.convert_array(w, p, i % 4, tl, noise_scale=0.0)
               for i, (w, p, tl) in enumerate(reqs)]
    results = [None] * len(reqs)
    with ServingDaemon(vc, max_batch=4, window_ms=300) as daemon:
        def client(i):
            w, p, tl = reqs[i]
            results[i] = daemon.submit(w, p, tl, i % 4, noise_scale=0.0).result(
                timeout=TIMEOUT)

        threads = [threading.Thread(target=client, args=(i,)) for i in range(len(reqs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=TIMEOUT)
        assert not any(t.is_alive() for t in threads)
        stats = daemon.stats()
    for got, want in zip(results, directs):
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert stats["requests"] == 4
    assert stats["mean_batch"] > 1.0  # the window coalesced a multi-request batch
    assert stats["latency_p95_ms"] >= stats["latency_p50_ms"] > 0


def test_noise_scale_never_mixes(vc):
    wav, pitch, tl = _prep(vc, 220.0)
    with ServingDaemon(vc, max_batch=8, window_ms=200) as daemon:
        futs = [daemon.submit(wav, pitch, tl, 0, noise_scale=ns) for ns in (0.0, 0.5, 0.0)]
        a, b, c = (f.result(timeout=TIMEOUT) for f in futs)
        stats = daemon.stats()
        sizes = list(daemon._batch_sizes)
    np.testing.assert_allclose(a, c, atol=1e-5, rtol=0)
    assert not np.allclose(a, b, atol=1e-3)
    assert stats["batches"] >= 2 and sorted(sizes) == [1, 2]


def test_mixed_lengths_keep_lengths_and_the_longest_row(vc):
    short = _prep(vc, 220.0, seconds=0.3)
    long = _prep(vc, 330.0, seconds=0.6)
    d_short = vc.convert_array(short[0], short[1], 1, short[2], noise_scale=0.0)
    d_long = vc.convert_array(long[0], long[1], 2, long[2], noise_scale=0.0)
    with ServingDaemon(vc, max_batch=4, window_ms=300) as daemon:
        f1 = daemon.submit(*short, 1, noise_scale=0.0)
        f2 = daemon.submit(*long, 2, noise_scale=0.0)
        o1, o2 = f1.result(timeout=TIMEOUT), f2.result(timeout=TIMEOUT)
        assert daemon.stats()["batches"] == 1
    assert len(o1) == len(d_short) and len(o2) == len(d_long)
    # the short row was padded to the long one inside the batch: its length
    # is exact, its values may differ a little (HuBERT's convs and the
    # decoder see the padding)
    np.testing.assert_allclose(o2, d_long, atol=1e-5, rtol=0)


def test_back_to_back_batches_resolve_every_row(vc):
    """6 equal-length requests at max_batch 2: 3 batches in flight behind
    each other; every row equals its solo conversion."""
    reqs = [_prep(vc, f) for f in (200.0, 240.0, 280.0, 320.0, 360.0, 400.0)]
    directs = [vc.convert_array(w, p, i % 4, tl, noise_scale=0.0)
               for i, (w, p, tl) in enumerate(reqs)]
    with ServingDaemon(vc, max_batch=2, window_ms=100) as daemon:
        futs = [daemon.submit(w, p, tl, i % 4, noise_scale=0.0)
                for i, (w, p, tl) in enumerate(reqs)]
        outs = [f.result(timeout=TIMEOUT) for f in futs]
        sizes = list(daemon._batch_sizes)
    assert len(sizes) >= 3 and sum(sizes) == 6
    for got, want in zip(outs, directs):
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_wire_formats_within_bounds(vc):
    wav, pitch, tl = _prep(vc, 220.0)
    direct = vc.convert_array(wav, pitch, 1, tl, noise_scale=0.0)
    assert np.abs(direct).max() > 0.05
    for mode in ("f16", "i16", "mulaw"):
        with ServingDaemon(vc, max_batch=2, window_ms=5, transfer=mode) as daemon:
            out = daemon.submit(wav, pitch, tl, 1, noise_scale=0.0).result(timeout=TIMEOUT)
        assert out.dtype == np.float32 and out.shape == direct.shape
        err = np.abs(out - direct)
        bound = 0.0225 * np.abs(direct) + 3e-3 if mode == "mulaw" else 2e-3
        assert np.all(err <= bound), f"{mode}: max excess {np.max(err - bound):.3g}"
    with pytest.raises(ValueError, match="transfer"):
        ServingDaemon(vc, transfer="i8")


def test_close_rejects_new_work(vc):
    daemon = ServingDaemon(vc, max_batch=2, window_ms=5)
    daemon.close()
    assert not daemon._thread.is_alive() and not daemon._resolver.is_alive()
    with pytest.raises(RuntimeError, match="closed"):
        daemon.submit(np.zeros(2560, np.float32), np.zeros(8, np.int64), 2560, 0)


def test_stream_pool_evicts_idle_other_key():
    """Idle sessions of one shape key must not 503 other keys
    (tests/test_serving.py's fake converter)."""
    class FakeConv:
        def __init__(self, vc, speaker_id, chunk_seconds, context_seconds, incremental,
                     noise_scale, rng_seed):
            self.chunk_seconds = chunk_seconds
            self.noise_scale = noise_scale
            self.rng_seed = rng_seed

        def reset(self):
            pass

        def set_speaker(self, sid):
            self.sid = sid

    pool = StreamPool(None, max_sessions=2)
    pool._cls = FakeConv
    a1 = pool.acquire(0, chunk_seconds=2.0)
    a2 = pool.acquire(0, chunk_seconds=2.0)
    assert a1 is not None and a2 is not None
    assert pool.acquire(0, chunk_seconds=2.0) is None  # truly at capacity
    pool.release(a1)
    pool.release(a2)
    b1 = pool.acquire(3, chunk_seconds=0.32)  # evicts an idle key-A session
    assert b1 is not None and b1.chunk_seconds == 0.32
    a3 = pool.acquire(1, chunk_seconds=2.0)
    assert (a3 is a1 or a3 is a2) and a3.sid == 1
    assert pool.acquire(0, chunk_seconds=2.0) is None


def test_http_convert_and_stats(vc, tmp_path):
    src = str(tmp_path / "in.wav")
    t = np.arange(int(SR * 0.4)) / SR
    write_wav(src, (0.4 * np.sin(2 * np.pi * 220 * t)).astype(np.float32), SR)
    wav, true_len, pitch = vc.prepare_source(src)
    with ServingDaemon(vc, max_batch=2, window_ms=5) as daemon:
        want = daemon.submit(wav, pitch, true_len, 1, noise_scale=0.0).result(timeout=TIMEOUT)
        with _http(daemon) as port:
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/convert?sid=1&noise_scale=0.01",  # -> 0.0
                data=open(src, "rb").read(), method="POST")
            with urllib.request.urlopen(req, timeout=TIMEOUT) as resp:
                assert resp.status == 200 and resp.headers["Content-Type"] == "audio/wav"
                (tmp_path / "out.wav").write_bytes(resp.read())
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/stats", timeout=30) as resp:
                stats = json.loads(resp.read())
    out, sr = read_wav(str(tmp_path / "out.wav"))
    assert sr == 48000 and out.shape == want.shape
    np.testing.assert_allclose(out, want, atol=1e-5, rtol=0)  # PCM_24 rounding
    assert stats["requests"] == 2 and stats["batches"] == 2


def _stream_once(port, path, payload: bytes, piece=4096):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT)
    try:
        conn.putrequest("POST", path)
        conn.putheader("Transfer-Encoding", "chunked")
        conn.endheaders()
        for i in range(0, len(payload), piece):
            p = payload[i:i + piece]
            conn.send(f"{len(p):x}\r\n".encode() + p + b"\r\n")
        conn.send(b"0\r\n\r\n")
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


@pytest.mark.parametrize("incremental", [False, True], ids=["windowed", "incremental"])
def test_http_stream_matches_direct(vc, incremental):
    """POST /stream: chunk-uploaded raw PCM converts to chunked raw PCM equal
    to a direct StreamingConverter run (f32), then again on the pooled,
    reset session; i16 within PCM-16 quantization; 400 on another rate."""
    t = np.arange(int(SR * 1.0)) / SR
    src = (0.4 * np.sin(2 * np.pi * 220 * t)).astype(np.float32)
    direct_conv = StreamingConverter(vc, speaker_id=1, chunk_seconds=0.32,
                                     context_seconds=0.16, noise_scale=0.0,
                                     incremental=incremental)
    direct = np.concatenate(list(direct_conv.push(src)) + list(direct_conv.flush()))
    path = (f"/stream?sid=1&chunk_seconds=0.32&context_seconds=0.16&noise_scale=0.0"
            f"&format=f32&incremental={int(incremental)}")
    with ServingDaemon(vc, max_batch=2, window_ms=5) as daemon, \
            _http(daemon, max_stream_sessions=1) as port:
        for _ in range(2):  # the second connection reuses the pooled session
            status, headers, body = _stream_once(port, path, src.astype("<f4").tobytes())
            assert status == 200 and headers.get("X-Sample-Rate") == "48000"
            np.testing.assert_allclose(np.frombuffer(body, dtype="<f4"), direct, atol=1e-5,
                                       rtol=0)
        status, _, body = _stream_once(port, path.replace("format=f32", "format=i16"),
                                       (np.clip(src, -1, 1) * 32767).astype("<i2").tobytes())
        got = np.frombuffer(body, dtype="<i2").astype(np.float32) / 32767
        assert status == 200 and got.shape == direct.shape
        # input and output are both PCM-16 here; the net amplifies the
        # input's 3e-5 step a little (JAX's bound, tests/test_serving.py)
        np.testing.assert_allclose(got, direct, atol=2e-2, rtol=0)
        status, _, _ = _stream_once(port, path + "&rate=8000", b"")
        assert status == 400


def test_http_stream_busy_returns_503(vc):
    with ServingDaemon(vc, max_batch=2, window_ms=5) as daemon, \
            _http(daemon, max_stream_sessions=0) as port:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.request("POST", "/stream?sid=1", body=b"")
        assert conn.getresponse().status == 503
        conn.close()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_cli_serve_answers_convert(vc, tmp_path, monkeypatch):
    """`python -m vcvits_tpu_torch.cli.serve`'s main on a tiny checkpoint,
    -a cpu: it loads the generator, serves one /convert equal to the
    converter's output, and returns when its server shuts down."""
    from vcvits_tpu_torch.cli import serve as cli
    from vcvits_tpu_torch.models import synthesizer
    from vcvits_tpu_torch.models.hubert import HubertConfig
    from vcvits_tpu_torch.train.checkpoint import CheckpointManager

    workdir = tmp_path / "run"
    mgr = CheckpointManager(str(workdir / "checkpoints"))
    mgr.save(3, {"step": 3, "gen": vc.gen.state_dict()})
    mgr.wait()
    (workdir / "config.json").write_text(json.dumps(CFG))
    monkeypatch.setattr(synthesizer, "hubert_config_for", lambda channels: HubertConfig(**HUBERT))
    servers = []

    def recording_serve_http(*args, **kwargs):
        servers.append(serve_http(*args, **kwargs))
        return servers[-1]

    monkeypatch.setattr(serving, "serve_http", recording_serve_http)
    port = _free_port()
    thread = threading.Thread(target=cli.main, args=([
        "--workdir", str(workdir), "-a", "cpu", "--port", str(port), "--max-batch", "2",
        "--window-ms", "5"],), daemon=True)
    thread.start()
    src = str(tmp_path / "in.wav")
    t = np.arange(int(SR * 0.4)) / SR
    write_wav(src, (0.3 * np.sin(2 * np.pi * 300 * t)).astype(np.float32), SR)
    try:
        deadline = time.monotonic() + TIMEOUT
        while not servers and time.monotonic() < deadline:
            time.sleep(0.05)
        req = urllib.request.Request(f"http://127.0.0.1:{port}/convert?sid=2&noise_scale=0",
                                     data=open(src, "rb").read(), method="POST")
        with urllib.request.urlopen(req, timeout=TIMEOUT) as resp:
            assert resp.status == 200
            (tmp_path / "out.wav").write_bytes(resp.read())
    finally:
        if servers:
            servers[0].shutdown()
        thread.join(timeout=60)
    assert not thread.is_alive()
    out, sr = read_wav(str(tmp_path / "out.wav"))
    wav, true_len, pitch = vc.prepare_source(src)
    want = vc.convert_array(wav, pitch, 2, true_len, noise_scale=0.0)
    assert sr == 48000 and out.shape == want.shape
    np.testing.assert_allclose(out, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("mode_args,quant", [([], True), (["--int8-decoder-mode", "w8"], "w8")])
def test_cli_serve_int8_decoder_builds_its_daemon(vc, tmp_path, monkeypatch, mode_args, quant):
    """`cli.serve --int8-decoder`, -a cpu, on a tiny checkpoint: the daemon's
    converter decodes in the chosen int8 mode, and its /convert equals
    that converter's convert_array at the request's padded length."""
    from vcvits_tpu_torch.cli import serve as cli
    from vcvits_tpu_torch.infer import VoiceConverter
    from vcvits_tpu_torch.models import synthesizer
    from vcvits_tpu_torch.models.hubert import HubertConfig
    from vcvits_tpu_torch.train.checkpoint import CheckpointManager

    workdir = tmp_path / "run"
    mgr = CheckpointManager(str(workdir / "checkpoints"))
    mgr.save(3, {"step": 3, "gen": vc.gen.state_dict()})
    mgr.wait()
    (workdir / "config.json").write_text(json.dumps(CFG))
    monkeypatch.setattr(synthesizer, "hubert_config_for", lambda channels: HubertConfig(**HUBERT))
    servers, daemons = [], []

    def recording_serve_http(*args, **kwargs):
        servers.append(serve_http(*args, **kwargs))
        return servers[-1]

    class RecordingDaemon(serving.ServingDaemon):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            daemons.append(self)

    monkeypatch.setattr(serving, "serve_http", recording_serve_http)
    monkeypatch.setattr(serving, "ServingDaemon", RecordingDaemon)
    port = _free_port()
    thread = threading.Thread(target=cli.main, args=([
        "--workdir", str(workdir), "-a", "cpu", "--port", str(port), "--max-batch", "2",
        "--window-ms", "5", "--int8-decoder", *mode_args],), daemon=True)
    thread.start()
    src = str(tmp_path / "in.wav")
    t = np.arange(int(SR * 0.4)) / SR
    write_wav(src, (0.3 * np.sin(2 * np.pi * 300 * t)).astype(np.float32), SR)
    try:
        deadline = time.monotonic() + TIMEOUT
        while not servers and time.monotonic() < deadline:
            time.sleep(0.05)
        req = urllib.request.Request(f"http://127.0.0.1:{port}/convert?sid=2&noise_scale=0",
                                     data=open(src, "rb").read(), method="POST")
        with urllib.request.urlopen(req, timeout=TIMEOUT) as resp:
            assert resp.status == 200
            (tmp_path / "out.wav").write_bytes(resp.read())
    finally:
        if servers:
            servers[0].shutdown()
        thread.join(timeout=60)
    assert not thread.is_alive()
    assert daemons[0].vc.gen.dec.quant_int8 == quant
    out, sr = read_wav(str(tmp_path / "out.wav"))
    q = VoiceConverter.from_checkpoint(str(workdir), device="cpu", quant_int8=quant,
                                       hubert_cfg=HubertConfig(**HUBERT))
    wav, true_len, pitch = q.prepare_source(src)
    want = q.convert_array(wav, pitch, 2, true_len, noise_scale=0.0)
    assert sr == 48000 and out.shape == want.shape
    np.testing.assert_allclose(out, want, atol=1e-5, rtol=0)
