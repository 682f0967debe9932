"""A train step's device work as one CUDA graph per batch shape (the FCOS
mutual step's, engine/fcos_trainer.py).

Launched kernel by kernel, a mutual step is some 8,700 launches, and the
iteration's one sync (the metrics fetch) empties the device's queue, so the
step runs at the host's launch rate. A replayed graph is one launch.
StepGraphs keeps one graph per signature of the batch (each tensor's key,
shape and dtype):
  * the first call of a signature runs the step eagerly, which is the
    call's own step and every first use (cuDNN plans, Triton compiles,
    cuBLAS workspaces), then captures it without running it; every later
    call replays the capture;
  * the graphs read the batch from static buffers, one per batch field and
    dtype, an image buffer holding a batch of the largest train canvas, each
    graph reading a view in its own shape; a call copies its batch in on
    the compute stream before the replay;
  * all the graphs allocate from one shared memory pool, and whatever
    outlives a replay lies outside it, made before the first capture: the
    parameters, the optimizer's fixed gradients, momentum buffers and
    learning rates, the EMA's rates, the static buffers, the metrics;
  * the step's draws come from the graphs' own generator, set to
    batch["rng"]'s seed and offset before each replay; the replay moves the
    offset on by what the step draws, and batch["rng"] takes it over. A CUDA
    generator's draw reads seed and offset from the device inside a graph,
    from the host outside one, and adds the same counts, so the numbers and
    the generator's state are those of the eager step;
  * a capture launches nothing: what the kernels' wrappers counted in it
    is taken back out of their launch counters (ops/kernels), and each
    replay adds it;
  * under a TorchDispatchMode (FlopCounterMode counting a step's FLOPs) a
    step runs eagerly and is not captured: a replay dispatches no op for
    the mode to see.
Spans: ubt.step.graph_capture, ubt.step.graph_replay (whose count the
trainer reports as `step_graph_replays`)."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterator, List, Tuple

import torch

from ..ops.kernels import add_launch_counts, launch_counts
from ..utils.events import span


def _leaves(batch: Dict[str, Any]) -> Iterator[Tuple[str, torch.Tensor]]:
    """(key, tensor) of the batch's tensors, a dataclass's fields as
    key.field; the generator and other values are not inputs."""
    for k, v in batch.items():
        if isinstance(v, torch.Tensor):
            yield k, v
        elif dataclasses.is_dataclass(v):
            for f in dataclasses.fields(v):
                t = getattr(v, f.name)
                if isinstance(t, torch.Tensor):
                    yield f"{k}.{f.name}", t


def _replace_leaves(batch: Dict[str, Any], views: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    out = {}
    for k, v in batch.items():
        if isinstance(v, torch.Tensor):
            out[k] = views[k]
        elif dataclasses.is_dataclass(v):
            out[k] = dataclasses.replace(v, **{f.name: views[f"{k}.{f.name}"] for f in dataclasses.fields(v)
                                               if f"{k}.{f.name}" in views})
        else:
            out[k] = v
    return out


@dataclasses.dataclass
class _Graph:
    graph: torch.cuda.CUDAGraph
    views: List[torch.Tensor]  # the static inputs, in _leaves order
    keys: List[str]  # the metrics, in the order of `out`
    out: torch.Tensor
    launches: Dict[str, int]  # the hand-written kernels' launches of a replay


class StepGraphs:
    """The captured steps of one train state, on one CUDA device."""

    def __init__(self, device: torch.device, canvas_area: int):
        self.device = torch.device(device)
        self.canvas_area = canvas_area  # pixels of the largest train canvas
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(self.device)
        self.generator = torch.Generator(device=self.device)
        self.graphs: Dict[tuple, _Graph] = {}
        self.buffers: Dict[Tuple[str, torch.dtype], torch.Tensor] = {}
        self.outs: Dict[int, torch.Tensor] = {}
        self.capturable = True

    def step(self, body: Callable[[Dict[str, Any]], Dict[str, torch.Tensor]], batch: Dict[str, Any],
             optimizer) -> Dict[str, torch.Tensor]:
        """body(batch) -> its metrics (device tensors), replayed where this
        batch's signature has a graph; else run, then captured."""
        if torch._C._len_torch_dispatch_stack():
            return body(batch)
        signature = tuple((k, tuple(t.shape), t.dtype) for k, t in _leaves(batch))
        entry = self.graphs.get(signature)
        if entry is not None:
            return self._replay(entry, batch, optimizer)
        metrics = body(batch)
        # a parameter the step leaves without a gradient keeps the step eager
        self.capturable = self.capturable and optimizer.static_grads()
        if self.capturable:
            self.graphs[signature] = self._capture(body, batch, list(metrics))
        return metrics

    def _static_views(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        views = {}
        for k, t in _leaves(batch):
            need = t.numel()
            if t.dim() == 4 and k.startswith("images_"):  # (B, H, W, C): room for the largest canvas
                need = max(need, t.shape[0] * self.canvas_area * t.shape[3])
            buf = self.buffers.get((k, t.dtype))
            if buf is None or buf.numel() < need:
                # a graph keeps the views it was captured with, and with them
                # any buffer this one replaces
                buf = self.buffers[(k, t.dtype)] = torch.empty(need, dtype=t.dtype, device=self.device)
            views[k] = buf[:t.numel()].view(t.shape)
        return views

    def _capture(self, body, batch: Dict[str, Any], keys: List[str]) -> _Graph:
        views = self._static_views(batch)
        if len(keys) not in self.outs:
            self.outs[len(keys)] = torch.empty(len(keys), dtype=torch.float64, device=self.device)
        out = self.outs[len(keys)]
        inputs = dict(_replace_leaves(batch, views), rng=self.generator)
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self.generator)
        if not self.graphs:
            # the allocator cannot free cached blocks while it captures: hand
            # them back before the first capture (as torch.cuda.graph does
            # before each), so that a dead state's graph pool is not held
            # beside this one's. Later captures find room beside the eager
            # steps' cache, which a new pair's first step needs again anyway
            torch.cuda.empty_cache()
        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        before = launch_counts()
        with span("ubt.step.graph_capture"), torch.cuda.stream(self.stream):
            graph.capture_begin(pool=self.pool)
            try:
                metrics = body(inputs)
                out.copy_(torch.stack([metrics[k].reshape(()).double() for k in keys]))
                del metrics
            except BaseException:
                try:
                    graph.capture_end()
                except RuntimeError:
                    pass  # the capture is broken already; the body's error says why
                raise
            graph.capture_end()
        launches = {k: n - before[k] for k, n in launch_counts().items() if n != before[k]}
        add_launch_counts({k: -n for k, n in launches.items()})
        return _Graph(graph, [views[k] for k, _ in _leaves(batch)], keys, out, launches)

    def _replay(self, entry: _Graph, batch: Dict[str, Any], optimizer) -> Dict[str, torch.Tensor]:
        for view, (_, t) in zip(entry.views, _leaves(batch)):
            view.copy_(t)
        optimizer.bind_grads()
        rng = batch["rng"]
        self.generator.manual_seed(rng.initial_seed())
        self.generator.set_offset(rng.get_offset())
        with span("ubt.step.graph_replay"):
            entry.graph.replay()
        add_launch_counts(entry.launches)
        rng.set_offset(self.generator.get_offset())
        out = entry.out.clone()
        return {k: out[i] for i, k in enumerate(entry.keys)}
