"""One CUDA graph per input signature for a module's inference forward.

The eval and serving steps launch some 2,350 small kernels a forward, and
the host takes longer to enqueue them than the card takes to run them.  A
:class:`ForwardGraphs` replays them as one CUDA graph instead, keyed by
what the forward's launches depend on (the batch's keys, shapes, strides,
dtypes and device, and the caller's flags):

- the first forward with a new key runs eagerly, on the stream that will
  capture: the warm-up fills the per-device constants
  (``ops/device_cache.py``) and that stream's cuBLAS and cuDNN state;
- the second captures the forward on that stream
  (``capture_error_mode="thread_local"``: a serving front end's completer
  thread waits on events meanwhile), then replays it;
- later ones copy the batch into the graph's static inputs on the current
  stream, replay, and return clones of its static outputs, so that each
  forward's outputs outlive the next replay.

The graph reads the module's parameters and buffers at their addresses, so
an in-place ``load_state_dict`` is seen by the next replay.  A parameter or
buffer that is replaced or moves (``module.to``, ``p.data = ...``,
``load_state_dict(assign=True)``, sharding) drops every graph of the
module; the next forwards warm up and capture again.  The per-device
constants a capture reads are kept by its graph.

Each forward counts once in :data:`graph_counts`: ``captures``,
``replays``, or ``eager`` (the caller's gate refused the graph, or the
forward warmed a new key up).  A replay runs no op wrapper, so it adds the
kernel launches counted at capture to ``ops.kernels.launch_counts``, and
records the span ``model.graph`` (its input copies, the replay and the
clones) in place of the spans inside the forward.
"""

from __future__ import annotations

import threading
import weakref
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import torch
from torch import nn

from hoisdf_torch.ops.device_cache import held
from hoisdf_torch.ops.kernels import graph_counts, launch_counts
from hoisdf_torch.parallel.zero import _is_fsdp
from hoisdf_torch.utils.profiling import span

_STATES: "weakref.WeakKeyDictionary[nn.Module, ForwardGraphs]" = weakref.WeakKeyDictionary()
_STREAMS: Dict[torch.device, torch.cuda.Stream] = {}
_STREAMS_LOCK = threading.Lock()


def on_card(batch: Mapping[str, Any]) -> bool:
    """Every value of ``batch`` is a tensor on one CUDA device."""
    devices = {v.device if isinstance(v, torch.Tensor) else None for v in batch.values()}
    dev = devices.pop() if len(devices) == 1 else None
    return dev is not None and dev.type == "cuda"


def untraced() -> bool:
    """Autograd is off and nothing traces or intercepts the ops, which a
    replay would bypass: ``torch.export`` or ``torch.compile``, a dispatch
    mode (``FlopCounterMode``, an export's fake tensors) or a function mode
    (``torch.device``)."""
    return not (torch.is_grad_enabled() or torch.compiler.is_compiling()
                or torch._C._len_torch_dispatch_stack()
                or torch._C._len_torch_function_stack())


def _slots(module: nn.Module) -> Tuple[List[tuple], bool]:
    """Every parameter and buffer of ``module`` as (owning dict, name,
    tensor, address), and whether any submodule is FSDP-sharded."""
    slots, sharded = [], False
    for m in module.modules():
        sharded = sharded or _is_fsdp(m)
        for d in (m._parameters, m._buffers):
            for name, t in d.items():
                if t is not None:
                    slots.append((d, name, t, t.data_ptr()))
    return slots, sharded


def _clone(out: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.clone() for k, v in out.items()}


def _capture_stream(dev: torch.device) -> torch.cuda.Stream:
    with _STREAMS_LOCK:
        if dev not in _STREAMS:
            _STREAMS[dev] = torch.cuda.Stream(device=dev)
        return _STREAMS[dev]


class _Graph:
    """A captured forward: its static inputs and outputs, the kernel
    launches its op wrappers counted, the device constants it reads, and
    the event recorded after its last outputs were cloned."""

    def __init__(self, device, graph, inputs, outputs, launches, kept):
        self.device, self.graph, self.inputs, self.outputs = device, graph, inputs, outputs
        self.launches: Dict[str, int] = launches
        self.kept = kept
        self.done = torch.cuda.Event()

    def outputs_cloned(self):
        """Clones of the static outputs, on the current stream."""
        stream = torch.cuda.current_stream(self.device)
        out = _clone(self.outputs)
        self.done.record(stream)
        return out

    def replay(self, batch: Mapping[str, torch.Tensor]):
        with span("model.graph"):
            # a replay on another stream than the last waits for its clones
            torch.cuda.current_stream(self.device).wait_event(self.done)
            for k, v in batch.items():
                self.inputs[k].copy_(v)
            self.graph.replay()
            out = self.outputs_cloned()
        for k, n in self.launches.items():
            launch_counts[k] += n
        graph_counts["replays"] += 1
        return out


class ForwardGraphs:
    """The graphs of one module, captured while its parameters and buffers
    stay where they were when it was made."""

    def __init__(self, module: nn.Module):
        self.slots, self.sharded = _slots(module)
        self.graphs: Dict[tuple, Optional[_Graph]] = {}  # None: warmed up, not captured

    def current(self) -> bool:
        for d, name, t, ptr in self.slots:
            if d.get(name) is not t or t.data_ptr() != ptr:
                return False
        return True

    def run(self, key: tuple, batch: Mapping[str, torch.Tensor],
            forward: Callable[[Mapping[str, torch.Tensor]], Dict[str, torch.Tensor]]):
        """``forward(batch)``'s outputs (a dict of tensors): warmed up,
        captured or replayed by ``key``."""
        if key in self.graphs:
            graph = self.graphs[key]
            if graph is None:
                graph = self.graphs[key] = self._capture(batch, forward)
                graph_counts["captures"] += 1
                return graph.outputs_cloned()
            return graph.replay(batch)
        out = self._warm_up(batch, forward)
        self.graphs[key] = None
        graph_counts["eager"] += 1
        return out

    @staticmethod
    def _warm_up(batch, forward):
        """Run ``forward`` eagerly on the capture stream."""
        dev = next(iter(batch.values())).device
        with torch.cuda.device(dev):
            cur, side = torch.cuda.current_stream(), _capture_stream(dev)
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                out = forward(batch)
            cur.wait_stream(side)
            for v in out.values():  # made on the side stream, read on this one
                v.record_stream(cur)
        return out

    @staticmethod
    def _capture(batch, forward) -> _Graph:
        """Capture ``forward`` on static copies of ``batch`` and run it once
        (a capture runs nothing)."""
        dev = next(iter(batch.values())).device
        with torch.cuda.device(dev):
            inputs = {k: v.clone() for k, v in batch.items()}
            before, kept = dict(launch_counts), []
            graph = torch.cuda.CUDAGraph()
            with held(kept), torch.cuda.graph(graph, stream=_capture_stream(dev),
                                              capture_error_mode="thread_local"):
                outputs = forward(inputs)
            graph.replay()
        launches = {k: n - before[k] for k, n in launch_counts.items() if n != before[k]}
        return _Graph(dev, graph, inputs, outputs, launches, kept)


def graphs_of(module: nn.Module) -> Optional[ForwardGraphs]:
    """``module``'s graphs, dropped and made anew where a parameter or
    buffer moved; None where a submodule is FSDP-sharded (its forward
    gathers the shards, a collective)."""
    state = _STATES.get(module)
    if state is None or not state.current():
        if state is not None and state.graphs:
            torch.cuda.synchronize()  # no replay of the graphs dropped is still running
        state = _STATES[module] = ForwardGraphs(module)
    return None if state.sharded else state
