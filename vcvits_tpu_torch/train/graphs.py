"""The single-rank GAN train step as CUDA graphs (train/step.py:GANStep).

Where it engages: on a CUDA device, on a `Mesh` of one rank (on more,
collectives sit inside the sections: the KL's mask sum, `sum_grads`,
`sum_metrics`), and under `remat_policy` "none" (`checkpointed` sets the
generators' states on the host inside the backward, which a graph cannot
replay). Elsewhere every call runs eagerly. Nothing else selects it.

A program is kept per batch signature (`signature`): the shapes and dtypes
of the batch's and the injected draws' tensors, which draws are injected,
and the mini-step phase when gradients accumulate. A step's calls run
eagerly until one has run eagerly and both AdamWs hold their state: those
calls make AdamW's state, the libraries' handles and plans, the kernels'
builds and the spectrogram's device tables, none of which a graph may
make. Then a call with an unseen signature captures it and replays it
once, so that call takes its own step; the calls after copy the batch and
the draws into the program's inputs and replay it. A capture that raises
leaves its signature eager from then on (and the captures after it a new
pool). `ops/_build.GRAPHS` counts the calls by how they ran.

The capture is cut at the program's spans (utils/profiling.py:
cut_at_spans): each enter and exit of a span ends the graph being
captured and begins the next, and the program records the boundary;
graphs that captured nothing are dropped. A replay walks the program: it
opens and closes the same spans in the same order and replays each graph
between them, so every kernel is launched inside the innermost span it
had in the eager step, and the section timings (`timings=`, CUDA events)
are recorded between the graphs. The walk is the span
"vcvits.train.graph_replay" (a capture's, with its first replay,
"vcvits.train.graph_capture"), inside "vcvits.train.step" and outside
every section. The profiler links a graph's kernels to its
`cudaGraphLaunch`, made inside the span the eager launches were made in.

What the graphs read and write across calls lives outside them, at fixed
addresses: the parameters, AdamW's state (its step count and learning rate
on the card: train/state.py:make_optimizer), the accumulator's means and
the program's inputs. All graphs of a step share one memory pool, so the
signatures share their activations' memory: one program replays at a
time, its graphs in capture order. The step's generators are registered
with every graph, so replayed draws advance them as eager draws do. The
kernels' wrappers count their launches in `LAUNCHES` while the capture
runs; the capture takes them back, and each replay adds its graphs'. After
a replay the trained parameters' version counters move, as AdamW's
in-place update moves them in an eager step, so a `FoldCache`
(models/layers.py) folds them again; before a capture the folds of the
modules holding a trained parameter are dropped, so that none made before
it is baked into a graph. Metrics are cloned out of the program's outputs,
so a caller's metrics outlive the next replay.
"""

from __future__ import annotations

import dataclasses
import logging
import warnings
import weakref
from typing import Callable, Dict, List, Optional

import torch

from vcvits_tpu_torch.models.layers import FoldCache
from vcvits_tpu_torch.ops import _build
from vcvits_tpu_torch.utils import profiling

logger = logging.getLogger(__name__)

Metrics = Dict[str, torch.Tensor]
_UNSEEN = object()


def signature(batch, draws, phase: int) -> Optional[tuple]:
    """The key of a call's program: each batch entry's and each draw's
    (shape, dtype, device), None for a draw left to the generators, and
    the mini-step phase; None where a batch entry is not a tensor."""
    if not all(isinstance(v, torch.Tensor) for v in batch.values()):
        return None
    return (tuple(sorted((k, _layout(v)) for k, v in batch.items())),
            tuple((f.name, _layout(getattr(draws, f.name))) for f in dataclasses.fields(draws)),
            phase)


def _layout(t: Optional[torch.Tensor]) -> Optional[tuple]:
    return None if t is None else (tuple(t.shape), t.dtype, t.device)


class _Program:
    """One signature's captured step: `ops` (("graph", graph, launches),
    ("open", name, ids), ("close",), ("mark", key)), its inputs, its
    outputs and the gradients it writes."""

    def __init__(self, batch: Dict[str, torch.Tensor], draws):
        self.batch, self.draws = batch, draws
        self.ops: List[tuple] = []
        self.graphs: List[torch.cuda.CUDAGraph] = []   # every graph captured, empty ones too
        self.outputs: Metrics = {}
        self.grads: List[Optional[torch.Tensor]] = []

    def load(self, batch, draws) -> None:
        """Copy a call's batch and draws into the inputs."""
        for k, v in batch.items():
            self.batch[k].copy_(v)
        for f in dataclasses.fields(draws):
            v = getattr(draws, f.name)
            if v is not None:
                getattr(self.draws, f.name).copy_(v)


class _Capture:
    """The capture of one program: a graph from each span boundary to the
    next (`boundary`), each registered with the step's generators and
    allocating from the step's pool, with the launches its kernels'
    wrappers counted meanwhile."""

    def __init__(self, prog: _Program, pool, generators):
        self.prog, self.pool, self.generators = prog, pool, generators
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.before: Dict[str, int] = {}
        self.counted: Dict[str, int] = {}   # every launch counted during the capture

    def begin(self) -> None:
        g = torch.cuda.CUDAGraph()
        for gen in self.generators:
            g.register_generator_state(gen)
        self.before = dict(_build.LAUNCHES)
        g.capture_begin(pool=self.pool)
        self.graph = g

    def end(self) -> None:
        g, self.graph = self.graph, None
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            g.capture_end()
        # every graph stays alive with the program: the pool is shared
        # only while some graph holds it
        self.prog.graphs.append(g)
        launches = self._since()
        if not any("empty" in str(w.message) for w in caught):
            self.prog.ops.append(("graph", g, launches))

    def boundary(self, op: tuple) -> None:
        if self.graph is None:  # after `abort`
            return
        self.end()
        self.prog.ops.append(op)
        self.begin()

    def abort(self) -> None:
        """End a capture that raised, and take the generators out of
        capture mode: an empty capture with them registered, in a pool of
        its own, ends theirs."""
        g, self.graph = self.graph, None
        self._since()
        if g is not None:
            try:
                g.capture_end()
            except RuntimeError:
                pass
        empty = torch.cuda.CUDAGraph()
        for gen in self.generators:
            empty.register_generator_state(gen)
        empty.capture_begin()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            empty.capture_end()

    def _since(self) -> Dict[str, int]:
        now = _build.LAUNCHES
        got = {k: n - self.before.get(k, 0) for k, n in now.items() if n != self.before.get(k, 0)}
        for k, n in got.items():
            self.counted[k] = self.counted.get(k, 0) + n
        self.before = dict(now)
        return got


class StepGraphs:
    """The CUDA graphs of one `GANStep` (the module docstring): `run` takes
    a call eagerly, by capture or by replay."""

    def __init__(self, step):
        # weakly: the step holds this, and a dropped step frees its pool at once
        self._step = weakref.ref(step)
        self.programs: Dict[tuple, Optional[_Program]] = {}  # None: its capture failed
        self.warm = False       # a call has run eagerly
        self.pool = None
        self.stream: Optional[torch.cuda.Stream] = None

    @property
    def step(self):
        return self._step()

    def engages(self) -> bool:
        s = self.step
        return (s.device.type == "cuda" and s.mesh.size == 1
                and s.cfg.train.remat_policy == "none")

    def clear(self) -> None:
        """Forget every program (after the state they address is replaced);
        the next capture starts a new pool."""
        self.programs.clear()
        self.pool = None

    def _ready(self) -> bool:
        s = self.step
        return self.warm and all(len(opt.state) == sum(len(g["params"]) for g in opt.param_groups)
                                 for opt in (s.g_opt, s.d_opt))

    def run(self, body: Callable, batch, draws, sections) -> Metrics:
        """body(batch, draws, sections) -> metrics, the step's sections:
        run eagerly, captured and replayed once, or replayed."""
        s = self.step
        key = prog = None
        if self.engages() and self._ready():
            key = signature(batch, draws, s.mini_step if s.g_acc.k > 1 else 0)
            prog = self.programs.get(key, _UNSEEN) if key is not None else None
        if prog is None:
            _build.GRAPHS["eager"] += 1
            out = body(batch, draws, sections)
            self.warm = True
            return out
        if prog is _UNSEEN:
            with profiling.span("train.graph_capture"):
                prog = self._capture(key, body, batch, draws, sections)
                if prog is None:
                    _build.GRAPHS["capture_failed"] += 1
                    return body(batch, draws, sections)
                _build.GRAPHS["captured"] += 1
                self._walk(prog, sections)
        else:
            prog.load(batch, draws)
            with profiling.span("train.graph_replay"):
                self._walk(prog, sections)
            _build.GRAPHS["replayed"] += 1
        return {k: v.clone() for k, v in prog.outputs.items()}

    def _capture(self, key, body, batch, draws, sections) -> Optional[_Program]:
        s = self.step
        dev = s.device
        prog = _Program({k: v.detach().clone() for k, v in batch.items()},
                        dataclasses.replace(draws, **{
                            f.name: getattr(draws, f.name).detach().clone()
                            for f in dataclasses.fields(draws)
                            if getattr(draws, f.name) is not None}))
        trained = {id(p) for p in s.g_params + s.d_params}
        for m in list(s.gen.modules()) + list(s.disc.modules()):
            if isinstance(m, FoldCache) and any(id(p) in trained for p in m.parameters()):
                m._folded = None
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        if self.stream is None:
            self.stream = torch.cuda.Stream(dev)
        cut = _Capture(prog, self.pool, (s.generator, s.dropout_generator))
        depth = len(sections.open)
        failed = False
        self.stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(self.stream):   # a capture ends on the stream it began on
            try:
                with profiling.cut_at_spans(cut):
                    cut.begin()
                    prog.outputs = {k: v.detach() for k, v in
                                    body(prog.batch, prog.draws, sections).items()}
                    cut.end()
            except Exception:  # noqa: BLE001 - any failure leaves the signature eager
                logger.warning("CUDA graph capture of a train step failed; its batch "
                               "signature runs eagerly from now on", exc_info=True)
                cut.abort()
                failed = True
        torch.cuda.current_stream(dev).wait_stream(self.stream)
        _build.add({k: -n for k, n in cut.counted.items()})
        if failed:
            while len(sections.open) > depth:   # the capture's boundaries, not ranges
                sections.open.pop()
            sections.key = None
            for m in list(s.gen.modules()) + list(s.disc.modules()):
                if isinstance(m, FoldCache):
                    m._folded = None
            for p in s.g_params + s.d_params:
                p.grad = None
            self.programs[key] = None
            self.pool = None   # the failed graphs let go of the pool: the next capture starts one
            return None
        # the program keeps its gradients: no later capture reuses their memory
        prog.grads = [p.grad for p in s.g_params + s.d_params]
        self.programs[key] = prog
        return prog

    def _walk(self, prog: _Program, sections) -> None:
        """Replay `prog`: its spans opened and closed, its graphs replayed
        between them, its section marks recorded."""
        stack = []
        for op in prog.ops:
            kind = op[0]
            if kind == "graph":
                op[1].replay()
                if op[2]:
                    _build.add(op[2])
            elif kind == "open":
                sp = profiling.span(op[1], **op[2])
                sp.__enter__()
                stack.append(sp)
            elif kind == "close":
                stack.pop().__exit__(None, None, None)
            else:
                sections.mark(op[1])
        torch.autograd.graph.increment_version(self.step.g_params + self.step.d_params)
