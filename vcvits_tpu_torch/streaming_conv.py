"""Incremental streaming of the flow reverse + decoder with cached conv state.

Counterpart of vcvits_tpu/streaming_conv.py. The flow reverse and the
HiFi-GAN decoder are conv stacks; they stream EXACTLY, chunk by chunk,
with per-layer cached state instead of recomputing a left context:

* every conv keeps a buffer of its last (k-1)*dilation input frames (the
  halo), so a chunk is one valid (pad-free) convolution over [cache |
  chunk];
* residual and skip paths carry delay buffers so that streams stay
  frame-aligned (a conv delays its output by `halo - left_pad` frames);
* every stream's values at offline coordinates < 0 (and, once the stream's
  length is known, >= its end) are zero, which makes the cached-state
  computation equal to the offline zero-padded ("same") convolution: the
  stream equals the offline output delayed by `delay_samples`;
* a transposed conv streams as zero-stuffing + a valid conv with the
  kernel flipped and its in/out channels swapped (PyTorch ConvTranspose1d
  arithmetic).

The convs are plain `F.conv1d` (through `models/layers.py:conv_op`, so a
bf16 conv on the CPU runs as float32 on the bf16 operands), as the JAX
package's are XLA convs: no kernel of the port is on this path. Streams
are [B, C, F] inside (PyTorch's conv layout); `step` takes z_p [B, F, C]
and returns [B, F * prod(upsample_rates), 1], the JAX package's layout.
The weights come from the port's own `SynthesizerSVC` modules, weight norm
folded once at `bind`. The chunk counter and the stream's length are
Python ints, so no coordinate sentinel limits how long a stream runs.
The content encoder stays windowed in `streaming.py` (its attention is
global). The decoder streams both res block kinds (ResBlock1 and
ResBlock2), always on the float weights: as in JAX, the int8 decoder modes
apply to the offline decoder only.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from vcvits_tpu_torch.models.layers import LRELU_SLOPE, conv_op, leaky_relu

ConvWeights = Tuple[torch.Tensor, torch.Tensor]  # ([out, in, k] kernel, [out] bias)


class S(NamedTuple):
    """A stream chunk: values and static alignment metadata.

    x: [B, C, F]; D: delay (stream index j holds offline coordinate j - D);
    F: frames a chunk at this stage's rate; R: rate multiplier relative to
    the pipeline's input frames (grows through upsampling).
    """

    x: torch.Tensor
    D: int
    F: int
    R: int = 1


def _conv1d_kernel(conv, dtype) -> ConvWeights:
    """A port Conv1d -> (kernel [out, in, k], bias) in `dtype`: weight norm
    folded in float32 (`kernel()`), then cast, as the JAX package folds."""
    kernel = conv.kernel().detach().to(dtype).contiguous()
    bias = conv.bias
    bias = (torch.zeros(kernel.shape[0], dtype=dtype, device=kernel.device) if bias is None
            else bias.detach().to(dtype))
    return kernel, bias


def _convtranspose1d_kernel(conv, dtype) -> ConvWeights:
    """A port ConvTranspose1d (kernel [in, out, k]) -> the forward conv that
    computes it on a zero-stuffed input: [out, in, k] with the taps
    flipped, and the bias."""
    kernel = conv.kernel().detach().flip(2).transpose(0, 1).to(dtype).contiguous()
    return kernel, conv.bias.detach().to(dtype)


def _linear(layer, dtype) -> ConvWeights:
    """A Linear (weight [out, in]) or a 1x1 Conv1d folded to [out, in]."""
    w = layer.kernel()[:, :, 0] if hasattr(layer, "kernel") else layer.weight
    return w.detach().to(dtype).contiguous(), layer.bias.detach().to(dtype)


class _Ctx:
    """Threads the buffer state through one streamed step.

    state=None is the spec-collection mode: every buffer reads as zeros and
    its shape is recorded (run once to build the initial state)."""

    def __init__(self, state: Optional[Dict], n: int, batch: int, dtype, device, spec: Dict,
                 total_frames: Optional[int] = None):
        self.state = state
        self.new: Dict[str, torch.Tensor] = {}
        self.n = n  # chunk counter
        self.B = batch
        self.dtype = dtype
        self.device = device
        self.spec = spec
        # input frames of the finite stream: None while streaming; the true
        # length during flush, so coords >= L are zeroed as the offline
        # right padding is
        self.L = total_frames

    def pull(self, name: str, frames: int, ch: int) -> torch.Tensor:
        if self.state is None:
            self.spec[name] = (self.B, ch, frames)
            return torch.zeros((self.B, ch, frames), dtype=self.dtype, device=self.device)
        return self.state[name]

    def push(self, name: str, val: torch.Tensor) -> None:
        self.new[name] = val


def _mask_neg(ctx: _Ctx, s: S) -> S:
    """Zero values at offline coordinates outside [0, L*R): those positions
    stand in for the offline conv's zero padding (left while warming up,
    right while flushing). A chunk wholly inside is returned as it is."""
    lo = ctx.n * s.F - s.D  # offline coordinate of stream index 0
    start = min(max(-lo, 0), s.F)
    end = s.F if ctx.L is None else min(max(ctx.L * s.R - lo, 0), s.F)
    if start == 0 and end == s.F:
        return s
    x = torch.zeros_like(s.x)
    if start < end:
        x[:, :, start:end] = s.x[:, :, start:end]
    return S(x, s.D, s.F, s.R)


def _sconv(ctx: _Ctx, s: S, name: str, kernel: torch.Tensor, bias: torch.Tensor,
           dilation: int = 1, pl: Optional[int] = None) -> S:
    """Streaming conv: a valid conv over [cache | chunk], the cache <- the
    last halo frames. pl = the offline left padding (default: torch
    'same'); the output delay grows by halo - pl."""
    k = kernel.shape[2]
    halo = (k - 1) * dilation
    if pl is None:
        pl = halo // 2
    if halo == 0:
        y = conv_op(F.conv1d, s.x, kernel, bias)
        return _mask_neg(ctx, S(y, s.D, s.F, s.R))
    buf = ctx.pull(name, halo, s.x.shape[1])
    xin = torch.cat([buf, s.x], dim=2)
    ctx.push(name, xin[:, :, xin.shape[2] - halo:].clone())
    y = conv_op(F.conv1d, xin, kernel, bias, dilation=dilation)
    return _mask_neg(ctx, S(y, s.D + (halo - pl), s.F, s.R))


def _sdelay(ctx: _Ctx, s: S, name: str, nfr: int) -> S:
    """Delay a stream by nfr frames through a FIFO buffer (skip-path
    alignment). The prefill zeros land at offline coords < 0."""
    if nfr == 0:
        return s
    buf = ctx.pull(name, nfr, s.x.shape[1])
    full = torch.cat([buf, s.x], dim=2)
    ctx.push(name, full[:, :, s.F:].clone())
    return S(full[:, :, : s.F], s.D + nfr, s.F, s.R)


def _sstuff(s: S, u: int) -> S:
    """Zero-stuff upsampling (the input dilation of a transposed conv):
    each frame followed by u - 1 zeros."""
    if u == 1:
        return s
    b, c, f = s.x.shape
    y = torch.zeros((b, c, f, u), dtype=s.x.dtype, device=s.x.device)
    y[..., 0] = s.x
    return S(y.reshape(b, c, f * u), s.D * u, s.F * u, s.R * u)


def _add_aligned(ctx: _Ctx, tag: str, streams: Sequence[S]) -> S:
    """Sum streams after equalizing their delays with FIFO buffers."""
    dm = max(s.D for s in streams)
    total = None
    for i, s in enumerate(streams):
        a = _sdelay(ctx, s, f"{tag}/al_{i}", dm - s.D)
        total = a.x if total is None else total + a.x
    return S(total, dm, streams[0].F, streams[0].R)


# --------------------------------------------------------------------- WN

def _wn_stream(ctx: _Ctx, s: S, layers: List[Tuple[ConvWeights, ConvWeights]],
               cond: Optional[torch.Tensor], tag: str, hidden: int, dilation_rate: int) -> S:
    """Streaming WN (models/wavenet.py): gated dilated convs, res/skip 1x1.
    layers: per layer (in conv, res_skip conv); cond [B, 2*hidden*layers, 1]
    from the speaker embedding, or None."""
    out = S(torch.zeros((s.x.shape[0], hidden, s.F), dtype=s.x.dtype, device=s.x.device),
            s.D, s.F, s.R)
    n_layers = len(layers)
    for i, ((kin, bin_), (krs, brs)) in enumerate(layers):
        x_in = _sconv(ctx, s, f"{tag}/in_{i}", kin, bin_, dilation=dilation_rate ** i)
        a, b = x_in.x[:, :hidden], x_in.x[:, hidden:]
        if cond is not None:
            g_l = cond[:, i * 2 * hidden:(i + 1) * 2 * hidden]
            a, b = a + g_l[:, :hidden], b + g_l[:, hidden:]
        acts = _mask_neg(ctx, S(torch.tanh(a) * torch.sigmoid(b), x_in.D, s.F, s.R))
        res_skip = _sconv(ctx, acts, f"{tag}/rs_{i}", krs, brs)
        out_al = _sdelay(ctx, out, f"{tag}/out_{i}", res_skip.D - out.D)
        if i < n_layers - 1:
            x_al = _sdelay(ctx, s, f"{tag}/res_{i}", res_skip.D - s.D)
            s = S(x_al.x + res_skip.x[:, :hidden], res_skip.D, s.F, s.R)
            out = S(out_al.x + res_skip.x[:, hidden:], res_skip.D, s.F, s.R)
        else:
            out = S(out_al.x + res_skip.x, res_skip.D, s.F, s.R)
    return out


# ------------------------------------------------------------------- flow

def _flow_reverse_stream(ctx: _Ctx, s: S, flows: List[Dict], g: Optional[torch.Tensor],
                         hidden: int, dilation_rate: int) -> S:
    """Streaming ResidualCouplingBlock reverse (models/flow.py): per
    coupling, last first, the channel flip, then x1 - m(x0)."""
    half = s.x.shape[1] // 2
    for i in reversed(range(len(flows))):
        w = flows[i]
        s = S(torch.flip(s.x, dims=[1]), s.D, s.F, s.R)  # the Flip flow, stateless
        x0 = S(s.x[:, :half], s.D, s.F, s.R)
        x1 = S(s.x[:, half:], s.D, s.F, s.R)
        h = _sconv(ctx, x0, f"flow{i}/pre", *w["pre"])
        cond = None
        if g is not None and w["cond"] is not None:
            cond = F.linear(g.to(ctx.dtype), *w["cond"])[:, :, None]
        h = _wn_stream(ctx, h, w["wn"], cond, f"flow{i}/enc", hidden, dilation_rate)
        m = _sconv(ctx, h, f"flow{i}/post", *w["post"])
        x1a = _sdelay(ctx, x1, f"flow{i}/x1", m.D - x1.D)
        x0a = _sdelay(ctx, x0, f"flow{i}/x0", m.D - x0.D)
        s = S(torch.cat([x0a.x, x1a.x - m.x], dim=1), m.D, s.F, s.R)
    return s


# ---------------------------------------------------------------- decoder

def _resblock_stream(ctx: _Ctx, s: S,
                     convs: List[Tuple[ConvWeights, Optional[ConvWeights]]],
                     dilations: Sequence[int], tag: str) -> S:
    """Streaming ResBlock1, per dilation s += c2(lrelu(c1(lrelu(s)))), or
    ResBlock2 (no second conv), per dilation s += c(lrelu(s))."""
    for i, (((k1, b1), second), d) in enumerate(zip(convs, dilations)):
        xt = S(leaky_relu(s.x, LRELU_SLOPE), s.D, s.F, s.R)
        if second is None:
            t2 = _sconv(ctx, xt, f"{tag}/c_{i}", k1, b1, dilation=d)
        else:
            t1 = _sconv(ctx, xt, f"{tag}/c1_{i}", k1, b1, dilation=d)
            t1 = S(leaky_relu(t1.x, LRELU_SLOPE), t1.D, t1.F, t1.R)
            t2 = _sconv(ctx, t1, f"{tag}/c2_{i}", *second)
        sk = _sdelay(ctx, s, f"{tag}/sk_{i}", t2.D - s.D)
        s = S(t2.x + sk.x, t2.D, s.F, s.R)
    return s


def _decoder_stream(ctx: _Ctx, s: S, dec: Dict, g: Optional[torch.Tensor], model) -> S:
    """Streaming HiFiGANGenerator (models/hifigan.py)."""
    s = _sconv(ctx, s, "dec/pre", *dec["pre"])
    if g is not None and dec["cond"] is not None:
        cond = F.linear(g.to(ctx.dtype), *dec["cond"])
        s = _mask_neg(ctx, S(s.x + cond[:, :, None], s.D, s.F, s.R))
    num_kernels = len(model.resblock_kernel_sizes)
    for i, (u, k) in enumerate(zip(model.upsample_rates, model.upsample_kernel_sizes)):
        s = _sstuff(S(leaky_relu(s.x, LRELU_SLOPE), s.D, s.F, s.R), u)
        s = _sconv(ctx, s, f"dec/up{i}", *dec["up"][i], pl=k - 1 - (k - u) // 2)
        branches = [_resblock_stream(ctx, s, dec["res"][i][j], dils, f"dec/res{i}_{j}")
                    for j, dils in enumerate(model.resblock_dilation_sizes)]
        s = _add_aligned(ctx, f"dec/mrf{i}", branches)
        s = S(s.x / num_kernels, s.D, s.F, s.R)
    s = S(leaky_relu(s.x, 0.01), s.D, s.F, s.R)  # torch's default final slope, as in JAX
    s = _sconv(ctx, s, "dec/post", *dec["post"])
    return S(torch.tanh(s.x), s.D, s.F, s.R)


# ------------------------------------------------------------------ facade

class StreamingFlowDecoder:
    """Stateful incremental flow reverse + decoder.

    Usage:
        sfd = StreamingFlowDecoder(cfg.model, chunk_frames).bind(gen)
        state = sfd.init_state()
        for each z_p chunk [B, F, C]:
            wav, state = sfd.step(state, z_p_chunk, g)
        # then feed sfd.flush_chunks() all-zero chunks, with total_frames
    The concatenated output, after dropping the first `delay_samples`
    samples, equals the offline flow reverse + decoder rendering.
    `model` gives the widths (a ModelConfig: inter_channels,
    hidden_channels, gin_channels, resblock, resblock_kernel_sizes,
    resblock_dilation_sizes, upsample_rates, upsample_kernel_sizes);
    `gen` the port's SynthesizerSVC, whose flow and decoder weights are
    folded once at `bind`.
    """

    def __init__(self, model, chunk_frames: int, batch: int = 1, dtype=torch.float32):
        self.model = model
        self.chunk_frames = int(chunk_frames)
        self.batch = batch
        self.dtype = dtype
        self.upsample = 1
        for u in model.upsample_rates:
            self.upsample *= u
        self._spec: Dict[str, Tuple[int, ...]] = {}
        self._weights: Optional[Dict] = None
        self.device: Optional[torch.device] = None
        self.delay_samples: Optional[int] = None

    def _run(self, state: Optional[Dict], n: int, total_frames: Optional[int],
             z_p: torch.Tensor, g: Optional[torch.Tensor]):
        w = self._weights
        ctx = _Ctx(state, n, self.batch, self.dtype, self.device, self._spec, total_frames)
        s = S(z_p.to(self.dtype).transpose(1, 2), 0, self.chunk_frames, 1)
        s = _flow_reverse_stream(ctx, s, w["flow"], g, w["hidden"], w["dilation_rate"])
        s = _decoder_stream(ctx, s, w["dec"], g, self.model)
        return s.x.transpose(1, 2), ctx.new, s.D

    def bind(self, gen) -> "StreamingFlowDecoder":
        """Fold the flow's and the decoder's weights of `gen` (the port's
        SynthesizerSVC) into this decoder's dtype, and size the state."""
        dt = self.dtype
        flows = []
        for i in range(gen.flow.n_flows):
            layer = getattr(gen.flow, f"flow_{i}")
            wn = layer.enc
            flows.append({
                "pre": _conv1d_kernel(layer.pre, dt), "post": _conv1d_kernel(layer.post, dt),
                "cond": None if wn.cond_layer is None else _linear(wn.cond_layer, dt),
                "wn": [(_conv1d_kernel(getattr(wn, f"in_{j}"), dt),
                        _conv1d_kernel(getattr(wn, f"res_skip_{j}"), dt))
                       for j in range(wn.n_layers)]})
        d = gen.dec
        dec = {"pre": _conv1d_kernel(d.conv_pre, dt), "post": _conv1d_kernel(d.conv_post, dt),
               "cond": None if d.cond is None else _linear(d.cond, dt),
               "up": [_convtranspose1d_kernel(getattr(d, f"up_{i}"), dt)
                      for i in range(d.n_stages)],
               "res": [[[(_conv1d_kernel(getattr(blk, f"c1_{t}"), dt),
                          _conv1d_kernel(getattr(blk, f"c2_{t}"), dt))
                         if d.resblock == "1" else
                         (_conv1d_kernel(getattr(blk, f"c_{t}"), dt), None)
                         for t in range(len(blk.dilations))]
                        for blk in (getattr(d, f"res_{i}_{j}")
                                    for j in range(len(d.kernel_sizes)))]
                       for i in range(d.n_stages)]}
        wn0 = gen.flow.flow_0.enc
        self._weights = {"flow": flows, "dec": dec, "hidden": wn0.hidden_channels,
                         "dilation_rate": wn0.dilation_rate}
        self.device = d.conv_pre.bias.device
        self.prepare(has_g=self.model.gin_channels > 0)
        return self

    @torch.no_grad()
    def prepare(self, has_g: bool = True) -> None:
        """Run one all-zero chunk in spec-collection mode to size the state
        buffers and the delay."""
        if self.delay_samples is None:
            z_p = torch.zeros((self.batch, self.chunk_frames, self.model.inter_channels),
                              dtype=self.dtype, device=self.device)
            g = (torch.zeros((self.batch, self.model.gin_channels), dtype=self.dtype,
                             device=self.device) if has_g else None)
            _, _, self.delay_samples = self._run(None, 0, None, z_p, g)

    def init_state(self) -> Dict:
        if self.delay_samples is None:
            raise RuntimeError("call bind(gen) first")
        bufs = {k: torch.zeros(v, dtype=self.dtype, device=self.device)
                for k, v in self._spec.items()}
        bufs["__n"] = 0  # chunks stepped
        return bufs

    def flush_chunks(self) -> int:
        """How many all-zero z_p chunks drain the pipeline tail."""
        per_chunk = self.chunk_frames * self.upsample
        return -(-self.delay_samples // per_chunk)

    @torch.no_grad()
    def step(self, state: Dict, z_p_chunk: torch.Tensor, g: Optional[torch.Tensor],
             total_frames: Optional[int] = None) -> Tuple[torch.Tensor, Dict]:
        """Process one z_p chunk [B, F, C] -> ([B, F * upsample, 1], state).
        Pass total_frames (the finite stream's input frames) on the flush
        calls, so that outputs beyond the end reproduce the offline right
        zero padding; leave None while the stream is live."""
        if self._weights is None:
            raise RuntimeError("call bind(gen) first")
        n = state["__n"]
        bufs = {k: v for k, v in state.items() if k != "__n"}
        y, new, _ = self._run(bufs, n, total_frames, z_p_chunk, g)
        new["__n"] = n + 1
        return y, new
