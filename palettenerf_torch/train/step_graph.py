"""A training step's device work captured once into a CUDA graph and replayed.

``StepGraphs`` keeps one ``torch.cuda.CUDAGraph`` per key, the key being what the step's
Python control flow reads (the trainer builds it). The first step of a key runs eagerly,
as the capture's warm-up: the optimizer's state, the kernels' builds and constants, the
refused-row counters and the libraries' workspaces are made then, outside any graph. The
key's next step is captured and replayed, every later one replayed.

The draws stay outside the graph: the caller makes a step's inputs eagerly and ``load``
copies them into the graph's own input tensors. Numbers that change between steps (the
lr, the loss weights) are read by the graph from ``DeviceScalars`` that the caller fills
before the launch. ``results`` copies the outputs out of the graph's, which the next
replay overwrites, and counts again what the captured code counted
(``utils.profiling.capture``).

The graphs of one ``StepGraphs`` share a memory pool: they run one at a time on one
stream, and each one's outputs are copied right after its replay. A graph reads the
tensors it was captured with: ``clear`` drops every graph (new parameters or optimizer).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import torch

from ..utils import profiling


class DeviceScalars:
    """Numbers a captured step reads from the device, by name: 0-d f32 tensors, each
    filled from the host (``set``, outside any capture) when its value changed."""

    def __init__(self, device, names: Sequence[str]):
        self._tensors = {n: torch.zeros((), dtype=torch.float32, device=device) for n in names}
        self._values = dict.fromkeys(names)

    def __getitem__(self, name: str) -> torch.Tensor:
        return self._tensors[name]

    def set(self, **values: float) -> None:
        for name, v in values.items():
            if self._values[name] != v:
                self._tensors[name].fill_(v)
                self._values[name] = v


class StepGraph:
    """One step captured into a CUDA graph (at its first ``launch``): ``body(inputs)``
    returns a tuple of tensors, and the graph's inputs and outputs are tensors of its own."""

    def __init__(self, body: Callable[[dict], tuple], owner: "StepGraphs"):
        self.body, self.owner = body, owner
        self.graph = None
        self.inputs: Optional[Dict[str, Optional[torch.Tensor]]] = None

    def load(self, inputs: Dict[str, Optional[torch.Tensor]]) -> None:
        """Copy the step's inputs (None: absent) into the graph's; the first load makes
        the graph's inputs as copies of these."""
        if self.inputs is None:
            self.inputs = {k: None if v is None else v.clone() for k, v in inputs.items()}
            return
        for k, v in inputs.items():
            if v is not None:
                self.inputs[k].copy_(v)

    def launch(self) -> None:
        """Run the loaded step: capture it at the first launch, then replay it."""
        if self.graph is None:
            graph = torch.cuda.CUDAGraph()
            with profiling.capture() as counted:
                with torch.cuda.graph(graph, pool=self.owner.pool):
                    outputs = self.body(self.inputs)
            self.graph, self.outputs, self.counted = graph, outputs, counted
            if self.owner.pool is None:
                self.owner.pool = graph.pool()
            profiling.count("train.graph.captures", 1)
        self.graph.replay()

    def results(self) -> tuple:
        """Copies of the last replay's outputs; what the capture counted is counted again
        (after the launch: the device counters are outputs of the replay)."""
        self.counted.replayed()
        profiling.count("train.graph.replays", 1)
        return tuple(t.clone() for t in self.outputs)


class StepGraphs:
    """A trainer's captured steps by key (see the module docstring)."""

    def __init__(self):
        self.clear()

    def clear(self) -> None:
        self._graphs: Dict[object, StepGraph] = {}
        self._warm: set = set()  # keys whose eager warm-up step has run
        self.pool = None  # the memory pool of the first capture, shared by the later ones

    def get(self, key, body: Callable[[dict], tuple]) -> Optional[StepGraph]:
        """The graph of ``key``, or None for the key's first step, which the caller runs
        eagerly. ``body`` is the step of a graph new here."""
        if key in self._graphs:
            return self._graphs[key]
        if key not in self._warm:
            self._warm.add(key)
            return None
        graph = self._graphs[key] = StepGraph(body, self)
        return graph
