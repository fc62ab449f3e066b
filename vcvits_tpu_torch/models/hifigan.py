"""HiFi-GAN MRF decoder (the 48 kHz waveform generator), PyTorch.

Counterpart of vcvits_tpu/models/hifigan.py on its unfolded path:
`conv_pre`, the speaker `cond` Dense added after it, per stage
lrelu(0.1) -> ConvTranspose (padding (k-u)//2) -> MRF (ResBlock1 blocks
summed then divided by their count), a final lrelu of slope 0.01,
`conv_post` and tanh. With fused_mrf=True (inference: `infer`,
`voice_conversion`) every stage's MRF goes through ops/mrf.py (kernel K1 on
a CUDA tensor), on weights folded once; K1 has no backward. With
fused_mrf=False (the training forward) every res block runs as modules,
its convs in the compute dtype with weight norm folded on each call with
its graph, the blocks summed and divided by their count in that dtype:
JAX's unfused ResBlock1 loop (vcvits_tpu/models/hifigan.py:56-80,
:278-286), which is its training path, so the res blocks train and a
bf16 step runs bf16 convolutions. The caller chooses, as in JAX; nothing
looks at requires_grad. The JAX package's space-to-depth tail folding and
dilation phase split are exact TPU rewrites of these convs and are not
carried over.

`quant_int8` is JAX's int8 decoder (inference only, same checkpoint):
True, dynamic W8A8, runs every conv (`conv_pre`, the upsamplers, every res
block conv, `conv_post`) through ops/int8_conv.py (`w8a8_forward`: one Q2
on conv_pre's input, then one Q1 a conv on the card), with the leaky ReLU
before each conv fused into its quantizer, and the module path's residual
adds, block sums and mean, and the speaker term, fused into the epilogue
of the conv before each, whatever `fused_mrf` says: a conv's activation
scale is a maximum over its whole input row, so the conv that writes the
row also takes its maximum for the next, and the pairs K1 fuses cannot be
fused. Its plain path (a CPU tensor) is the module path's op sequence bit
for bit. "w8" keeps every path and runs it on the weights' int8-grid
copies in the compute dtype, K1 included. ResBlock2 (`resblock="2"`: per
dilation x += c_i(lrelu(x))) runs as modules in float and "w8", as in
JAX, and through the same W8A8 driver in W8A8.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from vcvits_tpu_torch.models.layers import (
    LRELU_SLOPE, Conv1d, ConvTranspose1d, FoldCache, Linear, check_quant_int8)
from vcvits_tpu_torch.ops import int8_conv
from vcvits_tpu_torch.ops.int8_conv import W8A8Conv, mrf_w8a8_slots
from vcvits_tpu_torch.ops.mrf import Block, mrf


class ResBlock1(nn.Module):
    """MRF residual block: per dilation, a dilated conv and a plain conv."""

    def __init__(self, channels: int, kernel_size: int = 3,
                 dilations: Tuple[int, ...] = (1, 3, 5), quant_int8: Union[bool, str] = False,
                 dtype=torch.float32):
        super().__init__()
        self.kernel_size = kernel_size
        self.dilations = tuple(dilations)
        self.dtype = dtype
        for i, d in enumerate(self.dilations):
            self.add_module(f"c1_{i}", Conv1d(channels, channels, kernel_size, dilation=d,
                                              weight_norm=True, kernel_init="normal",
                                              quant_int8=quant_int8, dtype=dtype))
            self.add_module(f"c2_{i}", Conv1d(channels, channels, kernel_size, weight_norm=True,
                                              kernel_init="normal", quant_int8=quant_int8,
                                              dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """This block alone, through ops/mrf.py (an MRF of one block)."""
        return mrf(x, [self.stacked_weights(self.dtype)], (self.kernel_size,),
                   (self.dilations,))

    def module_forward(self, x: torch.Tensor) -> torch.Tensor:
        """The block as differentiable modules in the compute dtype: per
        dilation x += c2(lrelu(c1(lrelu(x))))."""
        x = x.to(self.dtype)
        for i in range(len(self.dilations)):
            xt = getattr(self, f"c1_{i}")(x, act_slope=LRELU_SLOPE)
            x = getattr(self, f"c2_{i}")(xt, act_slope=LRELU_SLOPE) + x
        return x

    def stacked_weights(self, dtype: torch.dtype) -> Block:
        """(w1 [D, k, C, C], b1 [D, C], w2, b2) in ops/mrf.py's layout, folded
        in float32 and cast to `dtype`, as fold_resblock_weights does;
        differentiable in the block's parameters (in "w8" mode the kernels
        are their int8-grid copies, which are not)."""
        def stack(prefix, attr):
            convs = [getattr(self, f"{prefix}_{i}") for i in range(len(self.dilations))]
            if attr == "kernel":
                ts = [c.compute_kernel().permute(2, 1, 0) for c in convs]  # [k, Cin, Cout]
            else:
                ts = [c.bias for c in convs]
            return torch.stack(ts).to(dtype).contiguous()
        return (stack("c1", "kernel"), stack("c1", "bias"),
                stack("c2", "kernel"), stack("c2", "bias"))


class ResBlock2(nn.Module):
    """The lighter MRF block: per dilation x += c_i(lrelu(x))."""

    def __init__(self, channels: int, kernel_size: int = 3, dilations: Tuple[int, ...] = (1, 3),
                 quant_int8: Union[bool, str] = False, dtype=torch.float32):
        super().__init__()
        self.kernel_size = kernel_size
        self.dilations = tuple(dilations)
        self.dtype = dtype
        for i, d in enumerate(self.dilations):
            self.add_module(f"c_{i}", Conv1d(channels, channels, kernel_size, dilation=d,
                                             weight_norm=True, kernel_init="normal",
                                             quant_int8=quant_int8, dtype=dtype))

    def module_forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        for i in range(len(self.dilations)):
            x = getattr(self, f"c_{i}")(x, act_slope=LRELU_SLOPE) + x
        return x


class HiFiGANGenerator(FoldCache):
    """[B, T, inter_channels] latent -> [B, T * prod(upsample_rates), 1] wave.

    Each stage's MRF weights are folded and stacked once (`mrf_weights`)
    and reused on every call until a parameter changes."""

    def __init__(self, initial_channel: int, resblock: str = "1",
                 resblock_kernel_sizes: Sequence[int] = (3, 7, 11),
                 resblock_dilation_sizes: Sequence[Sequence[int]] = ((1, 3, 5),) * 3,
                 upsample_rates: Sequence[int] = (8, 8, 4, 2),
                 upsample_initial_channel: int = 512,
                 upsample_kernel_sizes: Sequence[int] = (16, 16, 4, 4),
                 gin_channels: int = 0, quant_int8: Union[bool, str] = False,
                 dtype=torch.float32):
        super().__init__()
        if resblock not in ("1", "2"):
            raise ValueError(f"resblock must be \"1\" or \"2\", got {resblock!r}")
        self.resblock = resblock
        self.quant_int8 = check_quant_int8(quant_int8)
        q = self.quant_int8
        res_cls = ResBlock1 if resblock == "1" else ResBlock2
        self.kernel_sizes = tuple(resblock_kernel_sizes)
        self.dilations = tuple(tuple(d) for d in resblock_dilation_sizes)
        self.n_stages = len(upsample_rates)
        self.dtype = dtype
        c0 = upsample_initial_channel
        self.conv_pre = Conv1d(initial_channel, c0, 7, padding=(3, 3), weight_norm=True,
                               quant_int8=q, dtype=dtype)
        self.cond = Linear(gin_channels, c0, dtype=dtype) if gin_channels > 0 else None
        ch = c0
        for i, (u, k) in enumerate(zip(upsample_rates, upsample_kernel_sizes)):
            ch_out = c0 // (2 ** (i + 1))
            self.add_module(f"up_{i}", ConvTranspose1d(
                ch, ch_out, k, stride=u, padding=(k - u) // 2, weight_norm=True,
                kernel_init="normal", quant_int8=q, dtype=dtype))
            for j, (rk, rd) in enumerate(zip(self.kernel_sizes, self.dilations)):
                self.add_module(f"res_{i}_{j}", res_cls(ch_out, rk, rd, quant_int8=q,
                                                        dtype=dtype))
            ch = ch_out
        self.conv_post = Conv1d(ch, 1, 7, padding=(3, 3), weight_norm=True, quant_int8=q,
                                dtype=dtype)
        # the blocks' mean divides by a tensor: PyTorch would multiply a CUDA
        # tensor by the reciprocal of a host number, an ulp off the quotient
        # at times, and a W8A8 decoder carries one moved code on to many
        self.register_buffer("block_count", torch.tensor(float(len(self.kernel_sizes))),
                             persistent=False)

    def mrf_weights(self) -> List[List[Block]]:
        """Per stage, its blocks' weights in ops/mrf.py's layout, folded
        without a graph and cached."""
        return self.folded(lambda: [
            [getattr(self, f"res_{i}_{j}").stacked_weights(self.dtype)
             for j in range(len(self.kernel_sizes))] for i in range(self.n_stages)])

    def w8a8_blocks(self, i: int) -> List[List[Tuple[W8A8Conv, ...]]]:
        """Stage i's blocks for ops/int8_conv.py:mrf_w8a8: per block, per
        dilation the convs of one residual step ((c1, c2) or (c,))."""
        names = ("c1_", "c2_") if self.resblock == "1" else ("c_",)
        blocks = []
        for j in range(len(self.kernel_sizes)):
            blk = getattr(self, f"res_{i}_{j}")
            blocks.append([tuple(getattr(blk, f"{n}{t}").w8a8_conv() for n in names)
                           for t in range(len(blk.dilations))])
        return blocks

    def w8a8_forward(self, x: torch.Tensor, g: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The W8A8 decode: the module path's ops, with every residual add,
        block sum, mean and the speaker term in the epilogue of the conv
        before it, and each conv's row maximum made by the conv that wrote
        its input (one Q2, on conv_pre's input, then one Q1 a conv on the
        card). Every conv goes through int8_conv.conv1d_w8a8."""
        x = x.to(self.dtype).contiguous()
        stages = [self.w8a8_blocks(i) for i in range(self.n_stages)]
        # row maxima: conv_pre's input and output, and a stage's upsampled
        # input, its MRF's inner ones and its output
        n_slots = 2 + sum(2 + mrf_w8a8_slots(b) for b in stages)
        slots = torch.empty(n_slots, x.shape[0], dtype=torch.float32, device=x.device)
        amax = int8_conv.row_absmax(x, None, slots)
        free = iter(slots[1:])
        cond = self.cond(g)[:, None, :] if g is not None and self.cond is not None else None
        pre = self.conv_pre.w8a8_conv()
        emit = next(free)
        x = int8_conv.conv1d_w8a8(x, pre.qw, pre.pad, pre.bias, pre.dilation, None, amax=amax,
                                  residual=cond, emit=emit, emit_slope=LRELU_SLOPE)
        for i in range(self.n_stages):
            up_layer = getattr(self, f"up_{i}")
            up, amax, emit = up_layer.w8a8_conv(), emit, next(free)
            x = int8_conv.conv1d_w8a8(x, up.qw, up.pad, up.bias, 1, LRELU_SLOPE, amax=amax,
                                      emit=emit, emit_slope=LRELU_SLOPE)
            x = x.reshape(x.shape[0], -1, up.qw.co // up_layer.stride)
            last = i == self.n_stages - 1
            amax, emit = emit, next(free)
            x = int8_conv.mrf_w8a8(x, amax, stages[i], LRELU_SLOPE, free, emit,
                                   0.01 if last else LRELU_SLOPE)
        post = self.conv_post.w8a8_conv()
        x = int8_conv.conv1d_w8a8(x, post.qw, post.pad, post.bias, post.dilation, 0.01,
                                  amax=emit)
        return torch.tanh(x)

    def forward(self, x: torch.Tensor, g: Optional[torch.Tensor] = None,
                fused_mrf: bool = True) -> torch.Tensor:
        if self.quant_int8 is True:
            return self.w8a8_forward(x, g)
        x = self.conv_pre(x)
        if g is not None and self.cond is not None:
            x = x + self.cond(g)[:, None, :]
        # K1 takes ResBlock1 stages in the float and "w8" modes
        use_k1 = fused_mrf and self.resblock == "1"
        stages = self.mrf_weights() if use_k1 else None
        n_blocks = len(self.kernel_sizes)
        for i in range(self.n_stages):
            x = getattr(self, f"up_{i}")(x, act_slope=LRELU_SLOPE).contiguous()
            if use_k1:
                x = mrf(x, stages[i], self.kernel_sizes, self.dilations)
                continue
            xs = getattr(self, f"res_{i}_0").module_forward(x)
            for j in range(1, n_blocks):
                xs = xs + getattr(self, f"res_{i}_{j}").module_forward(x)
            x = xs / self.block_count
        x = self.conv_post(x, act_slope=0.01)  # torch's default slope, as in JAX
        return torch.tanh(x)
