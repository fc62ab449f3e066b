"""Non-causal WaveNet stack (gated dilated convs, global conditioning).

Counterpart of vcvits_tpu/models/wavenet.py: n_layers of [dilated conv ->
gate with the speaker conditioning -> 1x1 res/skip], all weight-normed. The
last layer's res_skip has H outputs (skip only), not 2H. `forward` is the
module path (training): the gate goes through ops/fused_gate.py (kernel K5
on a CUDA tensor, with its backward). `kernel_forward` is the no-grad path:
WN_SEGMENT_LAYERS layers a launch of ops/flow_coupling.py:wn_segment
(kernel K2's WaveNet mode, the gate its epilogue) on weights folded once.
"""

from __future__ import annotations

from typing import Optional

import torch

from vcvits_tpu_torch.models.layers import Conv1d, FoldCache
from vcvits_tpu_torch.ops.flow_coupling import WN_SEGMENT_LAYERS, Weights, wn_segment
from vcvits_tpu_torch.ops.fused_gate import fused_gate


class WN(FoldCache):
    def __init__(self, hidden_channels: int, kernel_size: int, dilation_rate: int,
                 n_layers: int, gin_channels: int = 0, dtype=torch.float32):
        super().__init__()
        h = hidden_channels
        self.hidden_channels = h
        self.kernel_size = kernel_size
        self.dilation_rate = dilation_rate
        self.n_layers = n_layers
        if gin_channels > 0:
            self.cond_layer = Conv1d(gin_channels, 2 * h * n_layers, 1, weight_norm=True,
                                     dtype=dtype)
        else:
            self.cond_layer = None
        for i in range(n_layers):
            self.add_module(f"in_{i}", Conv1d(h, 2 * h, kernel_size, dilation=dilation_rate ** i,
                                              weight_norm=True, dtype=dtype))
            out = 2 * h if i < n_layers - 1 else h
            self.add_module(f"res_skip_{i}", Conv1d(h, out, 1, weight_norm=True, dtype=dtype))

    def cond_vector(self, g: Optional[torch.Tensor], folded=None) -> Optional[torch.Tensor]:
        """[B, gin] speaker vector -> [B, n_layers * 2H] conditioning (fp32),
        or None without a speaker; `folded` is `cond_weights()`, if the
        caller keeps it."""
        if g is None or self.cond_layer is None:
            return None
        w, b = self.cond_weights() if folded is None else folded
        return torch.addmm(b, g.float(), w)

    def cond_weights(self):
        """The speaker layer folded: (W [gin, n_layers * 2H], b), float32, or
        None without one."""
        c = self.cond_layer
        if c is None:
            return None
        return c.kernel()[:, :, 0].t().detach().float().contiguous(), c.bias.detach().float()

    def kernel_weights(self) -> Weights:
        """Folded float32 (w_in [L, K, H, 2H], b_in [L, 2H], w_rs [L, H, 2H],
        b_rs [L, 2H]) in ops/flow_coupling.py's layout, the last layer's
        res_skip packed into the skip half."""
        if self.dilation_rate != 1:
            raise NotImplementedError("the WaveNet kernel takes dilation rate 1")
        h = self.hidden_channels
        w_in, b_in, w_rs, b_rs = [], [], [], []
        for i in range(self.n_layers):
            conv = getattr(self, f"in_{i}")
            w_in.append(conv.kernel().permute(2, 1, 0))  # [K, H, 2H]
            b_in.append(conv.bias)
            rs = getattr(self, f"res_skip_{i}")
            kr, br = rs.kernel()[:, :, 0].t(), rs.bias      # [H, 2H | H]
            if kr.shape[1] == h:  # last layer: pack into the skip half
                kr = torch.cat([torch.zeros_like(kr), kr], dim=1)
                br = torch.cat([torch.zeros_like(br), br])
            w_rs.append(kr)
            b_rs.append(br)
        ws = (torch.stack(w_in), torch.stack(b_in), torch.stack(w_rs), torch.stack(b_rs))
        return tuple(w.detach().float().contiguous() for w in ws)

    def kernel_forward(self, x: torch.Tensor, x_mask: torch.Tensor,
                       g: Optional[torch.Tensor] = None) -> torch.Tensor:
        """`forward` without gradients: WN_SEGMENT_LAYERS layers a call of
        ops/flow_coupling.py:wn_segment, float32 between them; the output in
        x's dtype."""
        (w_in, b_in, w_rs, b_rs), cw = self.folded(lambda: (self.kernel_weights(),
                                                            self.cond_weights()))
        cond = self.cond_vector(g, cw)
        two_h = 2 * self.hidden_channels
        h, skip = x, torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        for s in range(0, self.n_layers, WN_SEGMENT_LAYERS):
            e = min(s + WN_SEGMENT_LAYERS, self.n_layers)
            cs = None if cond is None else cond[:, s * two_h:e * two_h].contiguous()
            h, skip = wn_segment(h, skip, x_mask, cs, (w_in[s:e], b_in[s:e], w_rs[s:e],
                                                       b_rs[s:e]))
        return (skip * x_mask.float()).to(x.dtype)

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor,
                g: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x: [B, T, H]; x_mask: [B, T, 1]; g: [B, gin]."""
        h = self.hidden_channels
        output = torch.zeros_like(x)
        cond = self.cond_layer(g[:, None, :]) if g is not None and self.cond_layer is not None \
            else None
        for i in range(self.n_layers):
            x_in = getattr(self, f"in_{i}")(x)
            g_l = cond[:, :, i * 2 * h:(i + 1) * 2 * h] if cond is not None else None
            acts = fused_gate(x_in, g_l, h)
            res_skip = getattr(self, f"res_skip_{i}")(acts)
            if i < self.n_layers - 1:
                x = (x + res_skip[..., :h]) * x_mask
                output = output + res_skip[..., h:]
            else:
                output = output + res_skip
        return output * x_mask
