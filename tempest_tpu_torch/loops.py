"""The device loops of an iteration: bodies in chunks, one host read a chunk.

JAX runs each loop of an iteration (the per-mode Student-t EM, the GMM EM,
the split rounds, the adaptive MCMC steps) as a `lax.while_loop` on the
device. Here a loop runs its bodies in chunks: a chunk is `length` bodies
back to back with no host read, and after it the host reads the loop's
exit predicate once (`LoopRun.read`). Every body freezes what has finished
(`torch.where` on a done flag, as a vmapped `while_loop` freezes its
finished lanes), so a chunk that runs past the exit changes nothing and
the result does not depend on the chunk length.

`Loops` holds the chunk length of each loop (`chunks`; 1 where absent,
which reads after every body) and, with `graphs=True` on a CUDA device,
runs each chunk as a `torch.cuda.CUDAGraph`:

- a loop's carry and its constants live in static buffers, one set per
  loop name and shapes; a loop entry copies its tensors into them, each
  replay updates the carry in place, and the loop's result is a copy of
  the carry (so the next entry may overwrite the buffers);
- a chunk of a given length is captured once, after one warm-up run of
  its bodies on the capture stream whose effects are undone (the
  registered generators' Philox offsets, the registered call counters and
  the kernels' launch counts are put back), and replayed from then on;
- the generators in `generators` are registered with every graph, so a
  replay draws what the eager bodies draw from the same offset and
  advances the offset as they would;
- `counters` holds the call counters of the hardware-PRNG kernels
  (`cuda_prng.PhiloxCounter`), whose device words the captured bodies
  read and advance; a capture leaves each where it was, and every replay
  advances its host mirror by what the capture's bodies advanced it;
- a capture counts no kernel launch; every replay adds the launches its
  capture made (`launch_counts`), so a kernel's count stays its true
  number of launches;
- a capture that fails (a body that reads the host, such as a likelihood
  calling `.item()`) raises `CaptureError` naming the cause and
  `on_device=False`; nothing falls back to eager execution.

A read copies the values with one non-blocking copy into pinned memory
and waits on an event: the chunk's one blocking host read. On the CPU
there are no graphs, and a read is a plain copy. `stats` counts, per loop,
the chunks, bodies, reads, captures and replays.
"""

from __future__ import annotations

from collections import Counter, defaultdict
from typing import Callable, Dict, List, Optional

import torch

from .ops import cuda_em, cuda_linalg, cuda_median, cuda_prng, cuda_reweight

Tensors = Dict[str, torch.Tensor]
Body = Callable[[Tensors, Tensors], Tensors]


class CaptureError(RuntimeError):
    """A loop chunk could not be captured as a CUDA graph."""


def launch_counts() -> Dict[str, int]:
    """Every kernel's launch count in this process, by kernel."""
    return {"ess_bisect": cuda_reweight.LAUNCHES, "ess_bisect_f64": cuda_reweight.LAUNCHES_F64,
            "ess_bracket": cuda_reweight.BRACKET_LAUNCHES, "sym_eigvals": cuda_linalg.LAUNCHES,
            "weighted_median": cuda_median.LAUNCHES, **cuda_em.LAUNCHES, **cuda_prng.LAUNCHES}


def _add_launches(delta: Dict[str, int], sign: int = 1) -> None:
    cuda_reweight.LAUNCHES += sign * delta["ess_bisect"]
    cuda_reweight.LAUNCHES_F64 += sign * delta["ess_bisect_f64"]
    cuda_reweight.BRACKET_LAUNCHES += sign * delta["ess_bracket"]
    cuda_linalg.LAUNCHES += sign * delta["sym_eigvals"]
    cuda_median.LAUNCHES += sign * delta["weighted_median"]
    for counts in (cuda_em.LAUNCHES, cuda_prng.LAUNCHES):
        for name in counts:
            counts[name] += sign * delta[name]


def _signature(tensors: Tensors) -> tuple:
    return tuple((k, tuple(v.shape), v.dtype) for k, v in sorted(tensors.items()))


class _Graph:
    """One captured chunk, the kernel launches its capture made and the
    calls (counter, n) it draws; `outputs` holds the tensors a
    straight-line stretch returns."""

    def __init__(self, graph: torch.cuda.CUDAGraph, launches: Dict[str, int], calls: list):
        self.graph, self.launches, self.calls = graph, launches, calls
        self.outputs: Tensors = {}

    def replay(self) -> None:
        self.graph.replay()
        _add_launches(self.launches)
        for counter, n in self.calls:  # the mirrors of what the replay drew
            counter.counter += n


class Loops:
    """The loops of one sampler: chunk lengths, reads, and the graph cache."""

    def __init__(self, device, chunks: Optional[Dict[str, int]] = None, graphs: bool = False,
                 generators: Optional[List[torch.Generator]] = None,
                 counters: Optional[list] = None):
        self.device = torch.device(device)
        self.chunks = dict(chunks or {})
        self.graphs = graphs
        self.generators = list(generators or [])
        self.counters = list(counters or [])
        self.stats: Dict[str, Counter] = defaultdict(Counter)
        self._statics: Dict[tuple, tuple] = {}
        self._graphs: Dict[tuple, _Graph] = {}
        self._pinned: Optional[torch.Tensor] = None
        self._event = None
        self._stream = None

    def chunk(self, name: str) -> int:
        """The bodies a chunk of loop `name` runs between its reads."""
        return self.chunks.get(name, 1)

    @property
    def graphed(self) -> bool:
        return self.graphs and self.device.type == "cuda"

    def read(self, name: str, *tensors: torch.Tensor) -> List[float]:
        """The values of `tensors` (flattened, in order) on the host: one
        blocking read, counted for loop `name`."""
        self.stats[name]["reads"] += 1
        flat = torch.cat([t.detach().reshape(-1).to(torch.float64) for t in tensors])
        if flat.device.type != "cuda":
            return flat.tolist()
        n = flat.numel()
        if self._pinned is None or self._pinned.numel() < n:
            self._pinned = torch.empty(max(n, 64), dtype=torch.float64, pin_memory=True)
            self._event = torch.cuda.Event()
        self._pinned[:n].copy_(flat, non_blocking=True)
        self._event.record()
        self._event.synchronize()
        return self._pinned[:n].tolist()

    def start(self, name: str, body: Body, carry: Tensors, consts: Tensors,
              static: tuple = ()) -> "LoopRun":
        """Enter loop `name`: `body(carry, consts) -> carry` is one body.
        `static` holds the Python values the body depends on besides the
        tensors' shapes; a graph is kept per name, shapes and `static`."""
        return LoopRun(self, name, body, carry, consts, static)

    def once(self, name: str, fn: Callable[[Tensors], Tensors], inputs: Tensors,
             static: tuple = ()) -> Tensors:
        """`fn(inputs) -> outputs`, the straight-line stretch `name` between
        two loops, as one graph replay when graphs are on."""
        if not self.graphed:
            return fn(inputs)
        key, inputs_s, _ = self._bind(name, inputs, {}, static)
        gkey = key + ("once",)
        if gkey not in self._graphs:
            outputs: Tensors = {}
            self._graphs[gkey] = self._capture(name, lambda: fn(inputs_s), outputs.update)
            self._graphs[gkey].outputs = outputs
        graph = self._graphs[gkey]
        graph.replay()
        self.stats[name]["replays"] += 1
        return {k: v.clone() for k, v in graph.outputs.items()}

    # -- graphs ------------------------------------------------------------
    def _bind(self, name: str, carry: Tensors, consts: Tensors, static: tuple):
        """The static buffers of loop `name` at these shapes, filled."""
        key = (name, _signature(carry), _signature(consts), static)
        if key not in self._statics:
            self._statics[key] = ({k: torch.empty_like(v) for k, v in carry.items()},
                                  {k: torch.empty_like(v) for k, v in consts.items()})
        carry_s, consts_s = self._statics[key]
        for src, dst in ((carry, carry_s), (consts, consts_s)):
            for k, v in src.items():
                dst[k].copy_(v)
        return key, carry_s, consts_s

    def _graph(self, key: tuple, body: Body, carry_s: Tensors, consts_s: Tensors,
               length: int) -> _Graph:
        gkey = key + (length,)
        if gkey not in self._graphs:
            def bodies():
                c = dict(carry_s)
                for _ in range(length):
                    c = body(c, consts_s)
                return c

            def commit(c):
                for k, v in carry_s.items():
                    v.copy_(c[k])

            self._graphs[gkey] = self._capture(key[0], bodies, commit)
        return self._graphs[gkey]

    def _capture(self, name: str, work: Callable[[], Tensors],
                 commit: Callable[[Tensors], None]) -> _Graph:
        """Capture `work()` (which reads static buffers only) and
        `commit(work())`, which writes its results where the graph keeps
        them, after one warm-up run of `work` alone, whose effects on the
        generators and the launch counts are undone: the warm-up leaves
        every static buffer as it was."""
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        stream, current = self._stream, torch.cuda.current_stream(self.device)
        offsets = [g.get_offset() for g in self.generators]
        calls = [c.counter for c in self.counters]
        before = launch_counts()
        # Warm-up: libraries and workspaces meet the capture stream eagerly.
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            work()
        current.wait_stream(stream)
        _add_launches({k: v - before[k] for k, v in launch_counts().items()}, -1)
        for g, offset in zip(self.generators, offsets):
            g.set_offset(offset)
        for c, n in zip(self.counters, calls):
            c.seek(n)

        graph = torch.cuda.CUDAGraph()
        for g in self.generators:
            graph.register_generator_state(g)
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            graph.capture_begin()
            try:
                commit(work())
            except Exception as exc:
                self._end_failed_capture(graph)
                raise self._capture_error(name, exc) from exc
            try:
                graph.capture_end()
            except Exception as exc:
                self._repair_generators(stream)
                raise self._capture_error(name, exc) from exc
        current.wait_stream(stream)
        captured = {k: v - before[k] for k, v in launch_counts().items()}
        _add_launches(captured, -1)
        drawn = [(c, c.counter - n) for c, n in zip(self.counters, calls)]
        for c, n in zip(self.counters, calls):  # the capture ran nothing on the device
            c.counter = n
        self.stats[name]["captures"] += 1
        return _Graph(graph, captured, [(c, k) for c, k in drawn if k])

    def _end_failed_capture(self, graph) -> None:
        try:
            graph.capture_end()
        except Exception:  # the capture is already invalid; its own error is reported
            pass
        self._repair_generators(torch.cuda.current_stream(self.device))

    def _repair_generators(self, stream) -> None:
        """A capture that fails leaves its generators in capture mode; one
        small capture that succeeds takes them out of it."""
        try:
            fix = torch.cuda.CUDAGraph()
            for g in self.generators:
                fix.register_generator_state(g)
            with torch.cuda.stream(stream):
                fix.capture_begin()
                torch.zeros(1, device=self.device)
                fix.capture_end()
        except Exception:  # best effort: the capture's own error is what is raised
            pass

    @staticmethod
    def _capture_error(name: str, exc: Exception) -> CaptureError:
        return CaptureError(
            f"capturing the {name!r} loop as a CUDA graph failed: {type(exc).__name__}: {exc}\n"
            "Everything a loop body runs (in the MCMC steps, the likelihood and the prior "
            "transform) must stay on the device: no .item(), bool(tensor), .tolist(), "
            ".cpu() or host copies. Run with run(on_device=False), which runs the same "
            "loops without CUDA graphs.")


class LoopRun:
    """One entry into a loop: its carry, advanced chunk by chunk."""

    def __init__(self, loops: Loops, name: str, body: Body, carry: Tensors, consts: Tensors,
                 static: tuple = ()):
        self.loops, self.name, self.body = loops, name, body
        self.graphed = loops.graphed
        if self.graphed:
            self._key, self.carry, self.consts = loops._bind(name, carry, consts, static)
        else:
            self.carry, self.consts = dict(carry), consts

    def advance(self, length: int, before_body: Optional[Callable[[], None]] = None) -> None:
        """Run `length` bodies; `before_body` is called before each one
        (eager runs only: a replay runs its bodies on the device)."""
        stats = self.loops.stats[self.name]
        stats["chunks"] += 1
        stats["bodies"] += length
        if self.graphed:
            self.loops._graph(self._key, self.body, self.carry, self.consts, length).replay()
            stats["replays"] += 1
            return
        for _ in range(length):
            if before_body is not None:
                before_body()
            self.carry = self.body(self.carry, self.consts)

    def read(self, *keys: str) -> List[float]:
        """The carry's `keys` on the host: the chunk's one read."""
        return self.loops.read(self.name, *(self.carry[k] for k in keys))

    def result(self) -> Tensors:
        """The carry; a copy of the static buffers after replays."""
        if self.graphed:
            return {k: v.clone() for k, v in self.carry.items()}
        return self.carry


def run_loop(loops: Optional[Loops], name: str, body: Body, carry: Tensors, consts: Tensors,
             static: tuple = ()) -> Tensors:
    """A whole loop: chunks of `loops.chunk(name)` bodies until the carry's
    scalar boolean "go" reads False. Every body must leave a carry whose
    "go" is False unchanged."""
    loops = loops or Loops(carry["go"].device)
    if carry["go"].dim() != 0:
        raise ValueError(f"the {name!r} loop's predicate must be a scalar")
    run = loops.start(name, body, carry, consts, static)
    while True:
        run.advance(loops.chunk(name))
        if not run.read("go")[0]:
            return run.result()
