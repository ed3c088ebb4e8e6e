"""CUDA graphs of the runners' stages: the online step's
(``runners.incremental.make_step``) and the offline passes'
(``runners.offline_two_pass``).

Issued one by one from Python, a frame's few hundred small operations keep
the card idle most of the time. On a CUDA device, with the model in eval
mode, the online step runs each of its three stages (the hint raycast, the
forward and the fuse) as the replay of a CUDA graph: one launch a stage.
Offline, a batch's forward is one replay in either pass, and pass 2's
raycast of the static hint volume another.

* ``capture(fn, args, pool)`` runs ``fn`` once under capture, the storage
  of ``args`` its static inputs, and returns a ``StageGraph``. Calling it
  copies new arguments into the static inputs, replays, and hands back
  copies of the outputs: the next replay rewrites the graph's own buffers,
  and callers keep outputs across frames (the source-feature cache, the
  benchmark's kept session).
* A graph reads everything else by address: the model's weights, and for
  the raycast and the fuse the volume. ``Stages`` keeps a model's graphs
  across the steps of many sessions, under a key that names the stage's
  settings and the shapes and types of its arguments. A key is captured at
  its second use: the first runs eagerly and warms what a capture cannot do
  (a kernel's build, cuDNN's set-up, ``utils.geometry.device_constant``'s
  copies, K1's packed weights).
* The forward's graphs hold for one state of the weights (their storage and
  versions, read once a step function, ``runners.incremental.make_step``):
  a new state drops them.
* Each session brings a new volume, and a graph cannot follow it to new
  storage. The graphs last across sessions where sessions repeat the
  volume's shape, as every reader's do: the synthetic reader's rooms are
  one size, and the others have no bounds of their own, so each scan gets
  the same +-10 m cube (``runners.common.scene_bounds_for_fusion``). A
  ``Slot`` keeps the storage of one volume, of the latest shape, and a
  later volume of that shape is copied into it once, at its first stage,
  and its values and weights moved onto it (``Slot.bind``,
  ``Tensor.set_``). A volume moved there before and still alive gets
  storage of its own back first, with its contents. A volume of another
  shape takes the place: the graphs that read the slot go with the storage
  they read, and the fuse hands back nothing, so no graph keeps an old
  volume. A model has two slots: the online step's running volume, read by
  its raycast and fuse, and pass 2's static hint volume, read by the
  raycasts of every batch shape and pose key; so each holds one volume,
  however many graphs read it.
* The graphs of one model share one memory pool. That is safe because no
  graph reads another's buffers: inputs are copied in, outputs are copied
  out right after their replay, and replays run one at a time on one stream.
* Counters: ``runner.graph_captures`` and ``runner.graph_replays``, and a
  span ``runner.graph_capture`` around each capture. The kernels' launch
  counters (``*.launches``) count while a stage is captured, though nothing
  runs then: the capture takes those counts back and each replay adds them,
  so on this path they say what the captured graph launches, not what a
  wrapper saw.
"""

from __future__ import annotations

import weakref

import torch

from doubletake_tpu_torch.utils import tracing


def tensors(tree) -> list:
    """The tensors of a nest of dicts, lists and tuples, in a fixed order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in tensors(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in tensors(x)]
    return []


def signature(tree):
    """What a graph's capture fixes about its arguments: the nest's
    structure and each tensor's shape, type and device."""
    if isinstance(tree, torch.Tensor):
        return (tuple(tree.shape), tree.dtype, tree.device)
    if isinstance(tree, dict):
        return tuple((k, signature(tree[k])) for k in sorted(tree))
    if isinstance(tree, (list, tuple)):
        return tuple(signature(x) for x in tree)
    return tree


def _map(fn, tree):
    """The nest with ``fn`` applied to each tensor."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, x) for x in tree)
    return tree


def owned(tree):
    """The nest with every tensor copied into storage of its own."""
    return _map(torch.Tensor.clone, tree)


def alias(t):
    """Another tensor object on ``t``'s storage. Not a view: a view keeps
    its base tensor object alive, and with it whatever storage that object
    is later moved to (``_move_to_copy``)."""
    return torch.empty(0, dtype=t.dtype, device=t.device).set_(
        t.untyped_storage(), t.storage_offset(), t.shape, t.stride())


def copy_into(static, tree):
    """Copy each tensor of ``tree`` into the matching tensor of ``static``."""
    for dst, src in zip(tensors(static), tensors(tree)):
        dst.copy_(src)


def _launches() -> dict:
    return {k: v for k, v in tracing.counters().items() if k.endswith(".launches")}


class StageGraph:
    """A captured stage: its graph, static inputs and outputs, and the
    kernel launches one replay issues ({counter: launches})."""

    def __init__(self, graph, inputs, outputs, launches: dict):
        self.graph, self.inputs, self.outputs, self.launches = graph, inputs, outputs, launches

    def __call__(self, *args):
        copy_into(self.inputs, args)
        self.graph.replay()
        for name, n in self.launches.items():
            tracing.count(name, n)
        tracing.count("runner.graph_replays")
        return owned(self.outputs)


def _record(fn, inputs, pool):
    """(the CUDA graph of ``fn(*inputs)``, its outputs). ``thread_local``:
    the loader's threads allocate page-locked memory while this thread
    captures."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, pool=pool, capture_error_mode="thread_local"):
        outputs = fn(*inputs)
    return graph, outputs


def capture(fn, args, pool) -> StageGraph:
    """``fn(*args)`` captured in the memory pool ``pool``. The graph's
    static inputs are the storage of ``args`` itself: a capture of the
    largest stage sets the memory peak, and a copy of its inputs would add
    to it. Afterwards the caller's tensors move to copies of their own
    (``Tensor.set_``), so later frames copied into the static inputs do not
    overwrite them. A tensor that ``args`` holds twice (an empty hint's
    zeros, say) gets a copy for its second place: later arguments may
    differ there, and one static input must not be copied over another."""
    seen = set()

    def static(t):
        if id(t) in seen:
            return t.clone()
        seen.add(id(t))
        return alias(t)

    inputs = _map(static, args)
    before = _launches()
    with tracing.span("runner.graph_capture"):
        graph, outputs = _record(fn, inputs, pool)
    launches = {k: n - before.get(k, 0) for k, n in _launches().items()
                if n != before.get(k, 0)}
    for name, n in launches.items():
        tracing.count(name, -n)
    for t in {id(t): t for t in tensors(args)}.values():
        _move_to_copy(t)
    tracing.count("runner.graph_captures")
    return StageGraph(graph, inputs, outputs, launches)


def _storage(t) -> int:
    return t.untyped_storage().data_ptr()


def _move_to_copy(t):
    """Give tensor ``t`` storage of its own, holding the same values."""
    t.set_(t.clone())


class Slot:
    """The storage of one volume, of the latest shape, and the graphs that
    read it (module doc)."""

    def __init__(self):
        # the volume's shape, the (values, weights) the graphs read, and weak
        # references to the tensors put on them; the graphs
        self.volume, self.bound, self.graphs = None, (), {}

    def bind(self, vol):
        """Put ``vol``'s values and weights on the storage that the graphs
        read (``Tensor.set_``, so every holder of those tensors follows).
        Returns the (values, weights) tensors those graphs read."""
        shape = (tuple(vol.values.shape), vol.values.dtype, vol.values.device)
        if self.volume is None or self.volume[0] != shape:
            self.volume = (shape, (alias(vol.values), alias(vol.weights)))
            self.graphs = {}
        elif _storage(vol.values) != _storage(self.volume[1][0]):
            for t, static in zip((r() for r in self.bound), self.volume[1]):
                if t is not None and _storage(t) == _storage(static):
                    _move_to_copy(t)
            copy_into(self.volume[1], (vol.values, vol.weights))
            vol.values.set_(self.volume[1][0])
            vol.weights.set_(self.volume[1][1])
        self.bound = (weakref.ref(vol.values), weakref.ref(vol.weights))
        return self.volume[1]


class Stages:
    """One model's stage graphs (module doc)."""

    def __init__(self, model):
        self.weights = list(model.parameters()) + list(model.buffers())
        self.pool = torch.cuda.graph_pool_handle()
        # the online step's running volume and pass 2's static hint volume
        self.running, self.static = Slot(), Slot()
        # the weights' key and the forward's graphs, which read them
        self.weights_at, self.on_weights = None, {}

    def weights_key(self) -> tuple:
        """The weights' storage and versions: a graph reads them by address,
        and K1's packed copy of its MLP is made when the forward is captured."""
        return tuple((t.data_ptr(), t._version) for t in self.weights)

    def run_on_volume(self, slot: Slot, key, fn, args):
        """``fn(*args)``, a stage that reads the volume bound to ``slot``
        (``run``)."""
        return self._run(slot.graphs, key, fn, args)

    def run_on_weights(self, weights_key, fn, args):
        """``fn(*args)``, the forward under weights ``weights_key`` (``run``)."""
        if weights_key != self.weights_at:
            self.weights_at, self.on_weights = weights_key, {}
        return self._run(self.on_weights, None, fn, args)

    def _run(self, graphs: dict, key, fn, args):
        """``fn(*args)``: eagerly at the key's first use, captured at its
        second, replayed after."""
        key = (key, signature(args))
        graph = graphs.get(key, False)
        if graph is False:
            graphs[key] = None
            return fn(*args)
        if graph is None:
            graph = graphs[key] = capture(fn, args, self.pool)
        return graph(*args)


_stages: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def stages(model, device):
    """The model's ``Stages`` on a CUDA device with the model in eval mode,
    made at their first use and dropped with the model; None elsewhere (the
    CPU, training), where the step runs eagerly."""
    if torch.device(device).type != "cuda" or model.training:
        return None
    s = _stages.get(model)
    if s is None:
        s = _stages[model] = Stages(model)
    return s
