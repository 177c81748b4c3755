"""The sharding planner: one mesh and layout oracle for DP x SP x PP x TP.

Port of tensor2robot_tpu/parallel/planner.py. A model declares what it is
(`ModelSpec`: its parameters, optimizer state and one preprocessed batch,
as shapes), the world declares where it runs (`Topology`: its ranks) and
how much memory a rank may use, and `plan()` derives the execution plan:
the mesh dims, the trainer's weight-update regime and the collective
schedule with its wire bytes (the quantized int8/fp8 regimes' formats
included). The ranking, its reasons, the estimates, the 13 presets and
the plan documents are the JAX package's, number for number; a
`ShardingPlan` drives the port's `Trainer(plan=...)` and
`train_eval_model` under `T2R_PLAN`.

Where the port differs:
  * `ModelSpec.from_model` builds the network and steps its optimizer on
    the `meta` device, so nothing is allocated, and preprocesses a meta
    copy of the batch. Shapes are kept in the flax layout
    (utils/jax_params.flax_dims), because the sharding rules decide on a
    flax kernel's dims; a pipelined encoder's stage entries are stacked
    [S, ...] as JAX's tree holds them. The optimizer state is the port's:
    torch's Adam keeps a step counter a parameter where optax keeps one,
    so opt_state is 4 bytes a parameter entry, less 4, above JAX's.
  * The predicted layout (`ShardingPlan.state_shardings`) is a spec a
    state entry: each dim's mesh dim (or dims) or None, in the entry's
    checkpoint layout (a stage entry stacked, its dim 0 over pipe).
    `audit_state_layout` holds it against what `Trainer.init_state`
    placed, entry by entry: the parameter layout of sharded_params, the
    dims zero2 slices, the quantized regime's flat rows, the pipe
    stages' entries, and every local tensor's shape.
  * `build_mesh()` makes the mesh over the whole world (a process group of
    exactly the plan's ranks), where JAX takes a prefix of the devices.
  * The measured tier times synced train steps of each shortlisted
    candidate (nothing is compiled): the slowest rank's median, and the
    peak device memory over the probe. `last_search()["probe_compiles"]`
    keeps JAX's key and counts probes (train_eval.plan_probe_count).
  * Rank 0 owns the plan cache (parallel/plan_cache.py): it reads and
    writes it and broadcasts the plan document, so ranks never disagree.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from tensor2robot_tpu_torch import flags
from tensor2robot_tpu_torch.parallel import collectives
from tensor2robot_tpu_torch.parallel import mesh as mesh_lib
from tensor2robot_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    EXPERT_AXIS,
    FSDP_AXIS,
    MIN_WEIGHT_SIZE,
    MODEL_AXIS,
    PIPE_AXIS,
    SEQUENCE_AXIS,
)
from tensor2robot_tpu_torch.utils.device import DEFAULT_DEVICE

__all__ = [
    "Constraints",
    "Leaf",
    "ModelSpec",
    "PlanError",
    "PlanResult",
    "ShardingPlan",
    "Topology",
    "audit_state_layout",
    "estimate_comm_bytes",
    "estimate_memory",
    "hand_sharded",
    "last_search",
    "measured_rerank",
    "parse_measure_setting",
    "placed_layout",
    "plan",
    "preset_names",
    "resolve_plan_from_flag",
    "resolve_preset",
]

#: A spec of one state entry: for each dim, the mesh dim it is cut over, a
#: tuple of mesh dims (a product, zero2 over several replica dims), or None.
Spec = Tuple[Union[None, str, Tuple[str, ...]], ...]


def hand_sharded(fn):
    """Marks a function that places tensors on the mesh by hand instead of
    through the planner's or mesh.py's rules, so the exemption is
    grep-able. No runtime effect."""
    return fn


# -- inputs -------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Leaf:
    """One entry's shape (flax layout), dtype name and bytes an element."""

    shape: Tuple[int, ...]
    dtype: str
    itemsize: int

    @classmethod
    def of(cls, tensor: torch.Tensor, shape: Optional[Sequence[int]] = None) -> "Leaf":
        return cls(tuple(int(d) for d in (tensor.shape if shape is None else shape)),
                   str(tensor.dtype).replace("torch.", ""), tensor.element_size())


def _tree_bytes(tree: Optional[Mapping[str, Leaf]]) -> int:
    return sum(math.prod(leaf.shape) * leaf.itemsize for leaf in (tree or {}).values())


def _flax_shape(name: str, shape: Sequence[int], stacked: bool) -> Tuple[int, ...]:
    """The flax layout of a state entry of torch `shape` (a stacked stage
    entry keeps its leading [S] dim)."""
    from tensor2robot_tpu_torch.utils.jax_params import flax_dims

    lead, rest = (tuple(shape[:1]), tuple(shape[1:])) if stacked else ((), tuple(shape))
    dims = flax_dims(name, len(rest))
    out = [0] * len(rest)
    for i, j in enumerate(dims):
        out[j] = int(rest[i])
    return lead + tuple(out)


def _net_kwargs(model) -> Dict[str, Any]:
    """The transformer geometry the model was built with (its
    `_net_kwargs`, or its wrapped model's), {} for a model without one."""
    for m in (model, getattr(model, "_model", None)):
        kwargs = getattr(m, "_net_kwargs", None)
        if kwargs:
            return kwargs
    return {}


def pipeline_stages(model) -> Optional[int]:
    """The pipeline stages the model was built with, None for a model
    family that takes none."""
    return _net_kwargs(model).get("pipeline_stages")


def _meta_tensor(leaf) -> torch.Tensor:
    dtype = (leaf.dtype if isinstance(leaf, torch.Tensor)
             else torch.from_numpy(np.empty(0, np.asarray(leaf).dtype)).dtype)
    return torch.empty(tuple(np.shape(leaf)), dtype=dtype, device="meta")


def _meta_struct(tree):
    if tree is None:
        return None
    out = type(tree)()
    for key, leaf in tree.items():
        out[key] = _meta_tensor(leaf)
    return out


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """What the planner needs to know about a model: its state shapes
    (built on the meta device: nothing is allocated) plus the transformer
    geometry that decides which dims are legal (a model without a
    sequence dimension cannot shard one). Entries are keyed by state-dict
    name, shapes in the flax layout."""

    #: {parameter name: Leaf}.
    param_shapes: Mapping[str, Leaf]
    #: {"<parameter name>/<state key>": Leaf} of the optimizer's state.
    opt_shapes: Optional[Mapping[str, Leaf]] = None
    #: {feature key: Leaf} of one preprocessed batch.
    batch_shapes: Optional[Mapping[str, Leaf]] = None
    has_ema: bool = False
    batch_size: Optional[int] = None
    seq_len: Optional[int] = None
    num_heads: Optional[int] = None
    head_dim: Optional[int] = None
    num_layers: Optional[int] = None
    d_model: Optional[int] = None
    #: True when the model family can be built with pipeline stages
    #: (plan.model_kwargs() carries the count the model must be built
    #: with: the planner plans, the caller constructs).
    pipeline_capable: bool = False

    @property
    def n_params(self) -> int:
        return sum(math.prod(leaf.shape) for leaf in self.param_shapes.values())

    @property
    def param_bytes(self) -> int:
        return _tree_bytes(self.param_shapes)

    @property
    def batch_bytes(self) -> int:
        return _tree_bytes(self.batch_shapes)

    @classmethod
    def from_model(cls, model, example_batch) -> "ModelSpec":
        """Builds the spec from a model and one host batch, on the meta
        device: the network (a pipelined one's stage entries stacked over
        its stages), one step of its optimizer (torch creates the state at
        the first step) and the batch preprocessed in train mode."""
        try:
            labels = _meta_struct(example_batch["labels"])
        except KeyError:
            labels = None
        features, _ = model.preprocessor.preprocess(
            _meta_struct(example_batch["features"]), labels, mode="train")
        with torch.device("meta"):
            network = model.create_network()
        stages = pipeline_stages(model) or 1
        named = list(network.named_parameters())
        whole = {name: ((stages,) if _stacked(name, stages) else ()) + tuple(p.shape)
                 for name, p in named}
        param_shapes = {name: Leaf.of(p, _flax_shape(name, whole[name],
                                                     _stacked(name, stages)))
                        for name, p in named}
        optimizer = model.create_optimizer()([p for _, p in named])
        for _, p in named:
            p.grad = torch.zeros_like(p)
        optimizer.step()
        opt_shapes = {}
        for index, entry in optimizer.state_dict()["state"].items():
            name = named[index][0]
            for key, value in entry.items():
                if value.ndim:
                    shape = whole[name] if tuple(value.shape) == tuple(named[index][1].shape) \
                        else tuple(value.shape)
                    opt_shapes[f"{name}/{key}"] = Leaf.of(
                        value, _flax_shape(name, shape, _stacked(name, stages)))
                else:
                    opt_shapes[f"{name}/{key}"] = Leaf.of(value)
        batch_shapes = {key: Leaf.of(value) for key, value in features.items()}
        leading = [leaf.shape[0] for _, leaf in sorted(batch_shapes.items())
                   if len(leaf.shape) >= 1]
        geometry = _net_kwargs(model)
        num_layers = geometry.get("num_layers")
        return cls(
            param_shapes=param_shapes,
            opt_shapes=opt_shapes,
            batch_shapes=batch_shapes,
            has_ema=bool(getattr(model, "use_avg_model_params", False)),
            batch_size=leading[0] if leading else None,
            seq_len=getattr(model, "_episode_length", None),
            num_heads=geometry.get("num_heads"),
            head_dim=geometry.get("head_dim"),
            num_layers=num_layers,
            d_model=geometry.get("d_model"),
            pipeline_capable=num_layers is not None,
        )


def _stacked(name: str, stages: int) -> bool:
    return stages > 1 and mesh_lib.is_stage_entry(name)


@dataclasses.dataclass(frozen=True)
class Topology:
    """Where the plan runs: the world's ranks and the per-rank memory
    budget (None = unbounded; `plan()` also honors T2R_PLAN_MEM_BUDGET)."""

    num_devices: int
    memory_bytes: Optional[int] = None
    kind: str = "host"

    @classmethod
    def detect(cls) -> "Topology":
        """The world of this process group (1 without one), kind "cuda"
        where a card is visible, else "cpu"."""
        ranks = dist.get_world_size() if dist.is_initialized() else 1
        return cls(num_devices=ranks, kind="cuda" if torch.cuda.is_available() else "cpu")


@dataclasses.dataclass(frozen=True)
class Constraints:
    """Knobs that narrow the factorization search. Defaults reproduce the
    trainer's standing conventions."""

    allow_sp: bool = True
    allow_pp: bool = True
    #: Tensor parallelism (the fsdp param-sharding dim): a candidate with
    #: tp > 1 is feasible only when some parameter shards under
    #: param_min_shard_size.
    allow_tp: bool = True
    #: None reads T2R_COLLECTIVE_QUANT / T2R_COLLECTIVE_BLOCK.
    collective_quant: Optional[str] = None
    collective_block: Optional[int] = None
    shard_weight_update: bool = True
    sequence_parallel_mode: str = "ring"
    param_min_shard_size: int = MIN_WEIGHT_SIZE
    #: Multiplier turning one batch's bytes into a peak-activation
    #: estimate.
    activation_multiplier: float = 8.0
    #: Pinned dim sizes, e.g. {"pipe": 2}; factorizations disagreeing
    #: with a pin are skipped.
    pinned: Optional[Mapping[str, int]] = None


# -- the plan -----------------------------------------------------------------


class PlanError(ValueError):
    """No factorization satisfies the constraints/memory budget; the
    message carries the closest candidate's estimate."""


@dataclasses.dataclass(frozen=True)
class ShardingPlan:
    """One executable layout: mesh dims, the weight-update regime and the
    rules that place each state entry.

    A plan-driven trainer (`Trainer(plan=...)`, `T2R_PLAN`) takes its mesh
    from `build_mesh()`, its regime's arguments from `compiled_kwargs()`
    and the model-construction arguments from `model_kwargs()`;
    `state_shardings()` predicts every state entry's placement, which
    `audit_state_layout` checks against what the trainer placed.
    """

    name: str
    data: int = 1
    fsdp: int = 1
    model: int = 1
    sequence: int = 1
    pipe: int = 1
    expert: int = 1
    shard_weight_update: bool = False
    #: Replica dims the weight update shards across: ("data",) is the
    #: classic ZeRO-2 regime; a 3D plan passes every dim the parameters
    #: are replicated over, e.g. ("data", "sequence").
    weight_update_axes: Tuple[str, ...] = (DATA_AXIS,)
    collective_quant: str = "none"
    collective_block: int = 512
    param_min_shard_size: int = MIN_WEIGHT_SIZE
    sequence_parallel_mode: str = "ring"
    #: Filled by plan(): the scoring estimates for the ranked table.
    memory_bytes: Optional[int] = None
    comm_bytes: Optional[int] = None

    # - shape -
    def axes_dict(self) -> Dict[str, int]:
        return {
            DATA_AXIS: self.data,
            FSDP_AXIS: self.fsdp,
            MODEL_AXIS: self.model,
            SEQUENCE_AXIS: self.sequence,
            PIPE_AXIS: self.pipe,
            EXPERT_AXIS: self.expert,
        }

    @property
    def num_devices(self) -> int:
        return math.prod(self.axes_dict().values())

    @property
    def weight_update_group(self) -> int:
        axes = self.axes_dict()
        return math.prod(axes[a] for a in self.weight_update_axes)

    def regime(self) -> str:
        """Which of the trainer's four placement regimes this plan is:
        'quant_zero2' (quantized collectives on the flat shard),
        'sharded_params' (fsdp/tensor parallelism), 'zero2' (whole
        parameters, sharded weight update), or 'replicated'. The trainer
        takes its regime from here (train_eval._resolve_layout)."""
        if self.collective_quant != "none":
            return "quant_zero2"
        if self.fsdp > 1 or self.model > 1:
            return "sharded_params"
        if self.shard_weight_update and self.weight_update_group > 1:
            return "zero2"
        return "replicated"

    # - construction surfaces -
    def build_mesh(self):
        """The plan's mesh over the world (mesh.make_mesh). The world must
        have exactly the plan's ranks: ValueError naming both sizes
        otherwise (JAX takes a prefix of the devices)."""
        ranks = dist.get_world_size() if dist.is_initialized() else 1
        if ranks != self.num_devices:
            raise ValueError(
                f"plan {self.name!r} runs on {self.num_devices} ranks but the world has "
                f"{ranks}; build_mesh takes the whole world")
        return mesh_lib.make_mesh(**self.axes_dict())

    def matches_mesh(self, mesh) -> bool:
        shape = mesh_lib.mesh_shape(mesh)
        return all(shape[axis] == size for axis, size in self.axes_dict().items())

    def compiled_kwargs(self) -> Dict[str, Any]:
        """The Trainer arguments this plan pins (authoritative: a plan-
        driven trainer takes its regime from here, not the env flags)."""
        return {
            "shard_weight_update": self.shard_weight_update,
            "weight_update_axes": self.weight_update_axes,
            "collective_quant": self.collective_quant,
            "collective_block": self.collective_block,
            "param_min_shard_size": self.param_min_shard_size,
        }

    def model_kwargs(self) -> Dict[str, Any]:
        """Model-construction arguments for mesh-aware model families (the
        transformer models): the model must be BUILT to match the plan."""
        out: Dict[str, Any] = {}
        if self.pipe > 1:
            out["pipeline_stages"] = self.pipe
        if self.sequence > 1:
            out["sequence_parallel_mode"] = self.sequence_parallel_mode
        return out

    # - predictions -
    def _axis_entry(self):
        axes = tuple(self.weight_update_axes)
        return axes[0] if len(axes) == 1 else axes

    def _entry_spec(self, name: str, shape: Sequence[int], mirror: bool) -> Spec:
        """The spec of one parameter entry (whole `shape`, the checkpoint
        layout) or, `mirror`, of its optimizer moments and EMA, under this
        plan's tree regimes."""
        none: List[Any] = [None] * len(shape)
        if self.pipe > 1 and mesh_lib.is_stage_entry(name):
            return tuple([PIPE_AXIS] + none[1:])
        regime = self.regime()
        if regime == "sharded_params":
            model_dim, fsdp_dim = mesh_lib.param_dims(
                name, shape, self.fsdp, self.model, self.param_min_shard_size)
            if model_dim is not None:
                none[model_dim] = MODEL_AXIS
            if fsdp_dim is not None:
                none[fsdp_dim] = FSDP_AXIS
        elif regime == "zero2" and mirror:
            dim = mesh_lib.weight_update_dim(shape, self.weight_update_group,
                                             self.param_min_shard_size, name)
            if dim is not None:
                none[dim] = self._axis_entry()
        return tuple(none)

    def state_shardings(self, shapes: Mapping[str, Sequence[int]],
                        buffers: Optional[Mapping[str, Sequence[int]]] = None,
                        ema: bool = False, flat: bool = False) -> Dict[str, Spec]:
        """The predicted spec of every state entry of a trainer on this
        plan: "params/<name>" and "buffers/<name>" for the network's
        parameters and buffers of whole (checkpoint-layout) `shapes` and
        `buffers`, and the optimizer moments ("opt/<name>") and EMA
        ("ema/<name>", with `ema`) of each parameter. In the quantized
        regime the moments and EMA are the flat vector's rows over data
        ("opt/flat", "ema/flat"), with the residuals ("residual/grad" [N,
        padded] and "residual/update" [padded]); with the flat optimizer
        update (`flat`) the moments and EMA are the one flat vector's, a
        pipe stage's own over a pipe dim. Scalars (the optimizer's step
        counters) are whole everywhere and are not listed."""
        out: Dict[str, Spec] = {}
        for name, shape in (buffers or {}).items():
            # Buffers (batch-norm statistics) stay whole in every regime
            # but a pipe stage's.
            staged = self.pipe > 1 and mesh_lib.is_stage_entry(name)
            out[f"buffers/{name}"] = ((PIPE_AXIS,) if staged else (None,)) + \
                (None,) * (len(shape) - 1) if shape else ()
        for name, shape in shapes.items():
            out[f"params/{name}"] = self._entry_spec(name, shape, mirror=False)
        regime = self.regime()
        if regime == "quant_zero2":
            out["opt/flat"] = (DATA_AXIS,)
            out["residual/grad"] = (DATA_AXIS, None)
            out["residual/update"] = (DATA_AXIS,)
            if ema:
                out["ema/flat"] = (DATA_AXIS,)
            return out
        if flat:
            staged = self.pipe > 1 and any(mesh_lib.is_stage_entry(n) for n in shapes)
            out["opt/flat"] = (PIPE_AXIS, None) if staged else (None,)
            if ema:
                out["ema/flat"] = out["opt/flat"]
            return out
        for name, shape in shapes.items():
            spec = self._entry_spec(name, shape, mirror=True)
            out[f"opt/{name}"] = spec
            if ema:
                out[f"ema/{name}"] = spec
        return out

    def collective_schedule(
        self, model_spec: Optional[ModelSpec] = None
    ) -> List[Dict[str, Any]]:
        """Which collectives fire on which dim each train step, with
        analytic per-device wire bytes when a ModelSpec is given (None
        otherwise)."""
        entries: List[Dict[str, Any]] = []
        n = model_spec.n_params if model_spec is not None else None
        regime = self.regime()
        if self.data > 1 or (
            regime in ("zero2", "quant_zero2")
            and self.weight_update_group > 1
        ):
            if regime == "quant_zero2":
                coll = collectives.get_collective(
                    self.collective_quant, self.collective_block
                )
                layout = (
                    collectives.FlatShardLayout(n, self.data, self.collective_block)
                    if n
                    else None
                )
                pre, post = (
                    collectives.wire_summary(coll, layout.padded)
                    if layout
                    else (None, None)
                )
                entries.append(
                    {
                        "site": "zero2_gradient_exchange",
                        "ops": ["reduce_scatter", "all_gather"],
                        "axes": [DATA_AXIS],
                        "collective": self.collective_quant,
                        "bytes_per_device_step": post,
                        "bytes_fp32_equivalent": pre,
                    }
                )
            elif regime == "zero2":
                entries.append(
                    {
                        "site": "zero2_gradient_exchange",
                        "ops": ["psum_scatter", "all_gather"],
                        "axes": list(self.weight_update_axes),
                        "collective": "none",
                        "bytes_per_device_step": 8 * n if n else None,
                        "bytes_fp32_equivalent": 8 * n if n else None,
                    }
                )
            else:
                entries.append(
                    {
                        "site": "gradient_all_reduce",
                        "ops": ["psum"],
                        "axes": [DATA_AXIS],
                        "collective": "none",
                        "bytes_per_device_step": 8 * n if n else None,
                        "bytes_fp32_equivalent": 8 * n if n else None,
                    }
                )
        if self.sequence > 1:
            ring = self.sequence_parallel_mode == "ring"
            entries.append(
                {
                    "site": "ring_kv_rotation" if ring else "ulysses_head_scatter",
                    "ops": ["ppermute"] if ring else ["all_to_all"],
                    "axes": [SEQUENCE_AXIS],
                    "collective": "none",
                    "bytes_per_device_step": _sp_bytes(self, model_spec),
                    "bytes_fp32_equivalent": _sp_bytes(self, model_spec),
                }
            )
        if self.fsdp > 1:
            entries.append(
                {
                    "site": "fsdp_param_gather",
                    "ops": ["all_gather", "reduce_scatter"],
                    "axes": [FSDP_AXIS],
                    "collective": "none",
                    "bytes_per_device_step": _tp_bytes(self, model_spec),
                    "bytes_fp32_equivalent": _tp_bytes(self, model_spec),
                }
            )
        if self.pipe > 1:
            entries.append(
                {
                    "site": "pipeline_activation_shift",
                    "ops": ["ppermute", "psum"],
                    "axes": [PIPE_AXIS],
                    "collective": "none",
                    "bytes_per_device_step": _pp_bytes(self, model_spec),
                    "bytes_fp32_equivalent": _pp_bytes(self, model_spec),
                }
            )
        return entries

    def to_json(self) -> Dict[str, Any]:
        out = dataclasses.asdict(self)
        out["weight_update_axes"] = list(self.weight_update_axes)
        out["regime"] = self.regime()
        out["num_devices"] = self.num_devices
        return out

    @classmethod
    def from_json(cls, doc: Mapping[str, Any]) -> "ShardingPlan":
        """Inverse of to_json (drops the derived regime/num_devices
        keys): a cached winner deserializes into a plan whose to_json is
        byte-identical to what was stored."""
        doc = dict(doc)
        doc.pop("regime", None)
        doc.pop("num_devices", None)
        axes = doc.get("weight_update_axes")
        if axes is not None:
            doc["weight_update_axes"] = tuple(axes)
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(doc) - known
        if unknown:
            raise ValueError(
                f"plan document carries unknown fields {sorted(unknown)} "
                "— a newer planner schema; bump the cache format version"
            )
        return cls(**doc)


# -- scoring ------------------------------------------------------------------


def _shard_factor(shape, group_size: int, min_size: int) -> int:
    """The shard factor the zero2 rule achieves on a leaf of flax
    `shape`: group_size when some dim divides, else 1."""
    return 1 if mesh_lib.weight_update_dim(shape, group_size, min_size) is None else group_size


def _param_shard_factor(shape, sharding_plan: ShardingPlan) -> int:
    """The divide factor param_sharding achieves on one leaf of flax
    `shape` under the plan's model/fsdp dims."""
    spec = mesh_lib.flax_param_spec(shape, sharding_plan.fsdp, sharding_plan.model,
                                    sharding_plan.param_min_shard_size)
    sizes = {MODEL_AXIS: sharding_plan.model, FSDP_AXIS: sharding_plan.fsdp}
    return math.prod(sizes[axis] for axis in spec if axis is not None)


def _tree_bytes_per_device(tree: Mapping[str, Leaf], sharding_plan: ShardingPlan,
                           shard_mirrors: bool) -> int:
    """Per-device bytes of state entries under the plan's placement:
    pipe-stage entries divide by the pipe dim; (when shard_mirrors) every
    other large-enough entry divides by the weight-update group."""
    total = 0.0
    regime = sharding_plan.regime()
    group = (
        sharding_plan.weight_update_group
        if shard_mirrors and regime in ("zero2", "quant_zero2")
        else 1
    )
    for name, leaf in tree.items():
        shape = leaf.shape
        leaf_bytes = math.prod(shape) * leaf.itemsize
        if (sharding_plan.pipe > 1 and len(shape) >= 1 and shape[0] == sharding_plan.pipe
                and mesh_lib.is_stage_entry(name)):
            total += leaf_bytes / sharding_plan.pipe
        elif regime == "sharded_params":
            total += leaf_bytes / _param_shard_factor(shape, sharding_plan)
        else:
            total += leaf_bytes / _shard_factor(
                shape, group, sharding_plan.param_min_shard_size
            )
    return int(total)


def estimate_memory(
    model_spec: ModelSpec,
    sharding_plan: ShardingPlan,
    activation_multiplier: float = 8.0,
) -> Dict[str, int]:
    """Analytic per-device memory estimate (bytes): the parameters as
    placed + a transient gradient copy + the optimizer/EMA mirrors under
    the plan's sharding + an activation term (batch bytes scaled by
    `activation_multiplier`, divided across the batch/sequence shards).
    Deliberately coarse: it ranks factorizations and rejects clear
    non-fits."""
    params = _tree_bytes_per_device(
        model_spec.param_shapes, sharding_plan, shard_mirrors=False
    )
    grads = params
    if sharding_plan.regime() == "quant_zero2":
        layout = collectives.FlatShardLayout(
            max(model_spec.n_params, 1),
            sharding_plan.data,
            sharding_plan.collective_block,
        )
        # mu + nu on the flat padded shard, plus the grad/update residual.
        opt = 2 * 4 * layout.shard_len
        ema = 4 * layout.shard_len if model_spec.has_ema else 0
        opt += 2 * 4 * layout.shard_len
    else:
        opt = (
            _tree_bytes_per_device(
                model_spec.opt_shapes, sharding_plan, shard_mirrors=True
            )
            if model_spec.opt_shapes is not None
            else 2 * params
        )
        ema = (
            _tree_bytes_per_device(
                model_spec.param_shapes, sharding_plan, shard_mirrors=True
            )
            if model_spec.has_ema
            else 0
        )
    batch_shards = sharding_plan.data * sharding_plan.fsdp
    seq_shards = sharding_plan.sequence
    activations = int(
        model_spec.batch_bytes * activation_multiplier
        / max(batch_shards * seq_shards, 1)
    )
    total = params + grads + opt + ema + activations
    return {
        "params": params,
        "grads": grads,
        "opt_state": opt,
        "ema": ema,
        "activations": activations,
        "total": total,
    }


def _sp_bytes(sharding_plan: ShardingPlan,
              model_spec: Optional[ModelSpec]) -> Optional[int]:
    """Per-device per-step sequence-parallel bytes: the ring rotates K and
    V (4-byte elements) through sp hops per layer, forward + backward
    (~2x); Ulysses moves Q/K/V + the output through one all_to_all round."""
    if model_spec is None or sharding_plan.sequence <= 1:
        return None
    ms = model_spec
    if None in (ms.batch_size, ms.seq_len, ms.num_heads, ms.head_dim,
                ms.num_layers):
        return None
    local_batch = max(ms.batch_size // max(sharding_plan.data, 1), 1)
    local_seq = ms.seq_len // sharding_plan.sequence
    tile = local_batch * local_seq * ms.num_heads * ms.head_dim * 4
    if sharding_plan.sequence_parallel_mode == "ulysses":
        return int(ms.num_layers * 2 * 4 * tile)
    hops = sharding_plan.sequence
    return int(ms.num_layers * 2 * 2 * tile * hops)


def _pp_bytes(sharding_plan: ShardingPlan,
              model_spec: Optional[ModelSpec]) -> Optional[int]:
    """Per-device per-step pipeline bytes: one activation microbatch
    shifted per tick over M + S - 1 ticks (M defaulting to 2S), forward +
    backward."""
    if model_spec is None or sharding_plan.pipe <= 1:
        return None
    ms = model_spec
    if None in (ms.batch_size, ms.seq_len, ms.d_model):
        return None
    stages = sharding_plan.pipe
    local_batch = max(ms.batch_size // max(sharding_plan.data, 1), 1)
    micro = min(2 * stages, local_batch)
    ticks = micro + stages - 1
    mb = max(local_batch // micro, 1)
    local_seq = ms.seq_len // max(sharding_plan.sequence, 1)
    act = mb * local_seq * ms.d_model * 4
    return int(2 * ticks * act)


def _tp_bytes(sharding_plan: ShardingPlan,
              model_spec: Optional[ModelSpec]) -> Optional[int]:
    """Per-device per-step tensor-parallel (fsdp param-sharding) bytes:
    two all-gathers of the sharded parameters and a reduce-scatter of the
    gradients, ~3 parameter volumes scaled by the (tp-1)/tp ring
    fraction."""
    if model_spec is None or sharding_plan.fsdp <= 1:
        return None
    n = model_spec.n_params
    tp = sharding_plan.fsdp
    return int(3 * 4 * n * (tp - 1) / tp)


def estimate_comm_bytes(
    model_spec: ModelSpec, sharding_plan: ShardingPlan
) -> Dict[str, Optional[int]]:
    """Per-device per-step comm estimate by dim, from the collectives'
    wire formats (the quantized regimes count their 1-byte payloads and
    per-block scales through wire_summary)."""
    n = model_spec.n_params
    dp_bytes: Optional[int] = 0
    regime = sharding_plan.regime()
    if regime == "quant_zero2":
        coll = collectives.get_collective(
            sharding_plan.collective_quant, sharding_plan.collective_block
        )
        layout = collectives.FlatShardLayout(
            max(n, 1), sharding_plan.data, sharding_plan.collective_block
        )
        dp_bytes = collectives.wire_summary(coll, layout.padded)[1]
    elif regime == "zero2" or sharding_plan.data > 1:
        dp_bytes = 8 * n if sharding_plan.weight_update_group > 1 or \
            sharding_plan.data > 1 else 0
    sp = _sp_bytes(sharding_plan, model_spec) or 0
    pp = _pp_bytes(sharding_plan, model_spec) or 0
    tp = _tp_bytes(sharding_plan, model_spec) or 0
    total = (dp_bytes or 0) + sp + pp + tp
    return {
        "data": dp_bytes or 0,
        "sequence": sp,
        "pipe": pp,
        "fsdp": tp,
        "total": total,
    }


# -- the search ---------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PlanResult:
    best: ShardingPlan
    #: Every candidate factorization, ranked: feasible plans first by
    #: (comm bytes, memory), then infeasible ones with their rejection
    #: reasons.
    table: Tuple[Dict[str, Any], ...]

    def to_json(self) -> Dict[str, Any]:
        return {"best": self.best.to_json(), "table": list(self.table)}


def _divisors(n: int) -> List[int]:
    return [d for d in range(1, n + 1) if n % d == 0]


def plan(
    model_spec: ModelSpec,
    topology: Topology,
    memory_budget: Optional[int] = None,
    constraints: Optional[Constraints] = None,
) -> PlanResult:
    """Enumerates DP x SP x PP x TP factorizations of the device count,
    scores them (memory fit first, then estimated comm bytes), and
    returns the winner plus the ranked table. This is the analytic tier;
    `measured_rerank` re-ranks a shortlist on measured step time and
    `resolve_plan_from_flag` wires both behind T2R_PLAN=auto with the
    plan cache (parallel/plan_cache.py) in front.

    memory_budget: per-device bytes; None falls back to
    topology.memory_bytes, then the T2R_PLAN_MEM_BUDGET flag (MB; 0 =
    unbounded). Raises PlanError, with the closest candidate's estimate
    in the message, when nothing fits.
    """
    constraints = constraints or Constraints()
    n = topology.num_devices
    budget = memory_budget
    if budget is None:
        budget = topology.memory_bytes
    if budget is None:
        budget_mb = flags.get_int("T2R_PLAN_MEM_BUDGET")
        budget = budget_mb << 20 if budget_mb > 0 else None
    quant = (
        constraints.collective_quant
        if constraints.collective_quant is not None
        else flags.get_enum("T2R_COLLECTIVE_QUANT")
    )
    block = (
        constraints.collective_block
        if constraints.collective_block is not None
        else flags.get_int("T2R_COLLECTIVE_BLOCK")
    )
    pinned = dict(constraints.pinned or {})
    tp_shardable = [leaf.shape for leaf in model_spec.param_shapes.values()]

    entries: List[Dict[str, Any]] = []
    candidates: List[Tuple[Tuple[int, int], ShardingPlan, Dict[str, Any]]] = []
    for tp in _divisors(n):
        for sp in _divisors(n // tp):
            for pp in _divisors(n // (tp * sp)):
                dp = n // (tp * sp * pp)
                axes = {
                    DATA_AXIS: dp,
                    FSDP_AXIS: tp,
                    SEQUENCE_AXIS: sp,
                    PIPE_AXIS: pp,
                }
                if any(axes.get(a, 1) != s for a, s in pinned.items()):
                    continue
                reasons: List[str] = []
                if sp > 1:
                    if not constraints.allow_sp:
                        reasons.append("sequence parallelism disallowed")
                    elif model_spec.seq_len is None:
                        reasons.append(
                            "model declares no sequence dimension"
                        )
                    elif model_spec.seq_len % sp:
                        reasons.append(
                            f"seq_len {model_spec.seq_len} % sp {sp} != 0"
                        )
                    elif (
                        constraints.sequence_parallel_mode == "ulysses"
                        and (model_spec.num_heads or 0) % sp
                    ):
                        reasons.append(
                            f"heads {model_spec.num_heads} % sp {sp} != 0"
                        )
                if pp > 1:
                    if not constraints.allow_pp:
                        reasons.append("pipeline parallelism disallowed")
                    elif not model_spec.pipeline_capable:
                        reasons.append("model is not pipeline-capable")
                    elif (model_spec.num_layers or 0) % pp:
                        reasons.append(
                            f"num_layers {model_spec.num_layers} % pp "
                            f"{pp} != 0"
                        )
                if tp > 1:
                    probe = ShardingPlan(
                        name="_probe", fsdp=tp,
                        param_min_shard_size=constraints.param_min_shard_size,
                    )
                    if not constraints.allow_tp:
                        reasons.append("tensor parallelism disallowed")
                    elif pp > 1:
                        reasons.append(
                            "tp x pp does not compose (stacked pipeline "
                            "stage params under param_sharding is "
                            "unvalidated)"
                        )
                    elif not any(
                        _param_shard_factor(shape, probe) > 1
                        for shape in tp_shardable
                    ):
                        reasons.append(
                            f"no param leaf >= "
                            f"{constraints.param_min_shard_size} elements "
                            f"with a dim divisible by tp {tp}"
                        )
                batch_shards = dp * tp
                if (
                    batch_shards > 1
                    and model_spec.batch_size is not None
                    and model_spec.batch_size % batch_shards
                ):
                    reasons.append(
                        f"batch {model_spec.batch_size} % (dp {dp} x tp "
                        f"{tp}) != 0"
                        if tp > 1
                        else f"batch {model_spec.batch_size} % dp {dp} != 0"
                    )
                wu_axes = tuple(
                    axis
                    for axis, size in ((DATA_AXIS, dp), (SEQUENCE_AXIS, sp))
                    if size > 1
                ) or (DATA_AXIS,)
                pure_dp = sp == 1 and pp == 1 and tp == 1
                name = f"dp{dp}_sp{sp}_pp{pp}"
                if tp > 1:
                    name += f"_tp{tp}"
                candidate = ShardingPlan(
                    name=name,
                    data=dp,
                    fsdp=tp,
                    sequence=sp,
                    pipe=pp,
                    shard_weight_update=constraints.shard_weight_update,
                    weight_update_axes=wu_axes,
                    collective_quant=(
                        quant
                        if (
                            quant != "none"
                            and pure_dp
                            and dp > 1
                            and constraints.shard_weight_update
                        )
                        else "none"
                    ),
                    collective_block=block,
                    param_min_shard_size=constraints.param_min_shard_size,
                    sequence_parallel_mode=(
                        constraints.sequence_parallel_mode
                    ),
                )
                memory = estimate_memory(
                    model_spec, candidate,
                    activation_multiplier=constraints.activation_multiplier,
                )
                comm = estimate_comm_bytes(model_spec, candidate)
                if budget is not None and memory["total"] > budget:
                    reasons.append(
                        f"memory estimate {memory['total']} B/device "
                        f"exceeds budget {budget} B"
                    )
                candidate = dataclasses.replace(
                    candidate,
                    memory_bytes=memory["total"],
                    comm_bytes=comm["total"],
                )
                entry = {
                    "plan": candidate.to_json(),
                    "memory": memory,
                    "comm": comm,
                    "feasible": not reasons,
                    "reasons": reasons,
                }
                entries.append(entry)
                if not reasons:
                    candidates.append(
                        ((comm["total"], memory["total"]), candidate, entry)
                    )

    entries.sort(
        key=lambda e: (
            not e["feasible"],
            e["comm"]["total"],
            e["memory"]["total"],
        )
    )
    if not candidates:
        closest = min(entries, key=lambda e: e["memory"]["total"], default=None)
        detail = (
            f"; closest candidate {closest['plan']['name']} needs "
            f"{closest['memory']['total']} B/device "
            f"(budget {budget} B): {closest['reasons']}"
            if closest
            else ""
        )
        raise PlanError(
            f"no feasible DP x SP x PP x TP factorization of {n} devices "
            f"under the given constraints/memory budget{detail}"
        )
    candidates.sort(key=lambda item: item[0])
    return PlanResult(best=candidates[0][1], table=tuple(entries))


# -- presets: the hand-wired regimes, named ----------------------------------

# Each preset pins the configuration a hand-wired call site uses (the
# JAX package's, on its 8-device host mesh). DP-family presets scale their
# data dim to the world's ranks; composed presets keep their pinned shapes.
_PRESETS: Dict[str, Dict[str, Any]] = {
    "dp": {},
    "dp_zero2": {"shard_weight_update": True},
    "dp_zero2_fp16": {
        "shard_weight_update": True, "collective_quant": "fp16",
    },
    "dp_zero2_int8": {
        "shard_weight_update": True, "collective_quant": "int8",
    },
    "dp_zero2_fp8_e4m3": {
        "shard_weight_update": True, "collective_quant": "fp8_e4m3",
    },
    "dp_zero2_fp8_e5m2": {
        "shard_weight_update": True, "collective_quant": "fp8_e5m2",
    },
    "sp_ring": {"data": 1, "sequence": 8},
    "sp_ulysses": {
        "data": 1, "sequence": 8, "sequence_parallel_mode": "ulysses",
    },
    "pp": {"data": 1, "pipe": 2},
    "dp_sp": {"data": 2, "sequence": 4},
    "dp_pp": {"data": 2, "pipe": 2},
    "dp_pp_zero2": {"data": 2, "pipe": 2, "shard_weight_update": True},
    # DP x SP x PP with the weight update sharded across both replica dims.
    "dp_sp_pp": {
        "data": 2,
        "sequence": 2,
        "pipe": 2,
        "shard_weight_update": True,
        "weight_update_axes": (DATA_AXIS, SEQUENCE_AXIS),
    },
}


def preset_names() -> Tuple[str, ...]:
    return tuple(sorted(_PRESETS))


def resolve_preset(
    name: str, num_devices: Optional[int] = None
) -> ShardingPlan:
    """A named plan for one hand-wired regime. DP-family presets (no
    explicit dims) absorb the device count (None: the world's ranks) into
    `data`; composed presets keep their pinned shapes."""
    spec = _PRESETS.get(name)
    if spec is None:
        raise KeyError(
            f"unknown plan preset {name!r}; available presets: "
            f"{', '.join(preset_names())} (selected by T2R_PLAN; 'auto' "
            "runs the factorization search, 'off' keeps the hand-wired "
            "path)"
        )
    spec = dict(spec)
    if "data" not in spec and "sequence" not in spec and "pipe" not in spec:
        spec["data"] = (
            num_devices if num_devices is not None else Topology.detect().num_devices
        )
    return ShardingPlan(name=name, **spec)


def parse_measure_setting(setting: Optional[str]) -> Optional[int]:
    """T2R_PLAN_MEASURE: 'off' -> None (analytic ranking only);
    'shortlist-N' -> N, the number of top analytic candidates the
    measured tier probes. Anything else is a loud error: a typo must not
    silently fall back to the cheap tier."""
    setting = (setting or "off").strip()
    if setting == "off":
        return None
    if setting.startswith("shortlist-"):
        try:
            n = int(setting[len("shortlist-"):])
        except ValueError:
            n = 0
        if n >= 1:
            return n
    raise ValueError(
        f"T2R_PLAN_MEASURE={setting!r}: expected 'off' or 'shortlist-N' "
        "with N >= 1 (e.g. shortlist-4)"
    )


#: Stats of the most recent resolve_plan_from_flag search.
_LAST_SEARCH: Dict[str, Any] = {}


def last_search() -> Dict[str, Any]:
    """A copy of the most recent auto-search's stats: {'source':
    'cache'|'analytic'|'measured', 'probe_compiles': the probes it ran
    (JAX's key; the port compiles nothing, train_eval.plan_probe_count),
    'fingerprint', 'plan', 'measured': [...]} (empty before any auto
    run)."""
    return dict(_LAST_SEARCH)


def measured_rerank(
    model,
    example_batch,
    result: PlanResult,
    *,
    shortlist: int,
    steps: int = 3,
    memory_budget: Optional[int] = None,
    device: Union[str, torch.device] = DEFAULT_DEVICE,
) -> Tuple[PlanResult, Dict[str, Any]]:
    """Tier 1 -> tier 2: probes the top `shortlist` feasible analytic
    candidates (train_eval.measure_plan_candidate on every rank: the
    candidate's mesh and trainer, the slowest rank's median of `steps`
    synced steps after a warmup, the peak device memory) and re-ranks on
    measured step time, with measured memory fit as a hard gate. Each
    probed table entry gains a 'measured' record, with the analytic
    against measured memory where the device reports it. Plans the model
    cannot run are skipped with the reason recorded; when nothing
    measures, the analytic winner stands. Every rank calls it."""
    from tensor2robot_tpu_torch.train import train_eval as train_eval_lib

    probed: List[Tuple[float, ShardingPlan, Dict[str, Any]]] = []
    shortlisted = [e for e in result.table if e["feasible"]][:shortlist]
    for rank, entry in enumerate(shortlisted):
        candidate = ShardingPlan.from_json(entry["plan"])
        probe = train_eval_lib.measure_plan_candidate(
            model, candidate, example_batch, steps=steps, device=device
        )
        probe["analytic_rank"] = rank
        measured_total = probe.get("memory_per_device_bytes")
        if measured_total:
            analytic_total = entry["memory"]["total"]
            probe["analytic_memory_error"] = {
                "analytic_total": analytic_total,
                "measured_total": measured_total,
                "ratio": analytic_total / measured_total,
            }
        if (
            memory_budget is not None
            and measured_total
            and measured_total > memory_budget
        ):
            probe["memory_fit"] = False
        else:
            probe["memory_fit"] = probe.get("step_time_ms") is not None
        entry["measured"] = probe
        if probe["memory_fit"] and probe.get("step_time_ms") is not None:
            probed.append((probe["step_time_ms"], candidate, entry))
    stats: Dict[str, Any] = {
        "shortlist": len(shortlisted),
        "measured": [
            {
                "name": entry["plan"]["name"],
                "step_time_ms": entry["measured"].get("step_time_ms"),
                "skipped": entry["measured"].get("skipped"),
                "analytic_rank": entry["measured"]["analytic_rank"],
            }
            for entry in shortlisted
        ],
    }
    if not probed:
        return result, stats
    probed.sort(key=lambda item: item[0])
    best = probed[0][1]
    for measured_rank, (_, _, entry) in enumerate(probed):
        entry["measured"]["measured_rank"] = measured_rank
    stats["winner"] = best.name
    return PlanResult(best=best, table=result.table), stats


def _from_rank0(doc):
    """Rank 0's `doc` on every rank (a broadcast; `doc` as it is without
    a process group)."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return doc
    box = [doc]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def _auto_search(model, example_batch, device) -> ShardingPlan:
    """The three-tier T2R_PLAN=auto pipeline: plan cache -> analytic
    enumeration -> optional measured re-rank, with the winner (and its
    table) written back to the cache so the next run on this (model,
    topology, torch, schema) key probes nothing. Rank 0 reads and writes
    the cache and its documents reach every rank by broadcast."""
    from tensor2robot_tpu_torch.parallel import plan_cache

    global _LAST_SEARCH
    chief = not dist.is_initialized() or dist.get_rank() == 0
    model_spec = ModelSpec.from_model(model, example_batch)
    directory = plan_cache.cache_dir()
    stats: Dict[str, Any] = {
        "setting": "auto",
        "cache_dir": directory,
        "probe_compiles": 0,
        "fingerprint": None,
    }
    fingerprint = None
    if directory:
        fingerprint = plan_cache.model_fingerprint(model_spec)
        stats["fingerprint"] = fingerprint
        payload = _from_rank0(plan_cache.load(fingerprint, directory) if chief else None)
        if payload is not None:
            best = ShardingPlan.from_json(payload["plan"])
            stats.update(source="cache", plan=best.name)
            _LAST_SEARCH = stats
            return best
    from tensor2robot_tpu_torch.train import train_eval as train_eval_lib

    probes_before = train_eval_lib.plan_probe_count()
    result = plan(model_spec, Topology.detect())
    stats.update(source="analytic", plan=result.best.name)
    shortlist = parse_measure_setting(flags.get_str("T2R_PLAN_MEASURE"))
    if shortlist:
        budget_mb = flags.get_int("T2R_PLAN_MEM_BUDGET")
        result, measured_stats = measured_rerank(
            model,
            example_batch,
            result,
            shortlist=shortlist,
            steps=flags.get_int("T2R_PLAN_MEASURE_STEPS"),
            memory_budget=budget_mb << 20 if budget_mb > 0 else None,
            device=device,
        )
        stats.update(
            source="measured",
            plan=result.best.name,
            measured=measured_stats,
        )
    stats["probe_compiles"] = train_eval_lib.plan_probe_count() - probes_before
    doc = _from_rank0({"plan": result.best.to_json(), "table": list(result.table)})
    best = ShardingPlan.from_json(doc["plan"])
    if directory and fingerprint:
        if chief:
            plan_cache.store(fingerprint, doc, directory)
        stats["stored"] = True
    stats["plan"] = best.name
    _LAST_SEARCH = stats
    return best


def resolve_plan_from_flag(
    model=None, example_batch=None, device: Union[str, torch.device] = DEFAULT_DEVICE,
) -> Optional[ShardingPlan]:
    """The T2R_PLAN gate: 'off' (default) -> None (the trainer's explicit
    arguments); a preset name -> that plan; 'auto' -> the three-tier
    search against the world's ranks (needs model + example_batch for the
    ModelSpec; the measured tier's probes run on `device`): plan-cache
    hit -> analytic enumeration -> T2R_PLAN_MEASURE's timed re-rank, the
    winner kept under T2R_PLAN_CACHE_DIR. With a process group every rank
    calls it with the same arguments."""
    setting = flags.get_str("T2R_PLAN") or "off"
    if setting == "off":
        return None
    if setting == "auto":
        if model is None or example_batch is None:
            raise ValueError(
                "T2R_PLAN=auto needs a model and an example batch to "
                "build the ModelSpec the search scores against"
            )
        return _auto_search(model, example_batch, device)
    return resolve_preset(setting)


# -- the audit ----------------------------------------------------------------


def local_shape(whole: Sequence[int], spec: Spec, mesh) -> Tuple[int, ...]:
    """A rank's shape of an entry of `whole` shape placed by `spec`: a
    stage entry (dim 0 over pipe) is its stage's slice, whole; every
    other cut dim is divided by the product of its mesh dims' sizes."""
    sizes = mesh_lib.mesh_shape(mesh)
    out = []
    for i, (size, entry) in enumerate(zip(whole, spec)):
        if entry == PIPE_AXIS and i == 0:
            continue
        axes = () if entry is None else (entry,) if isinstance(entry, str) else entry
        out.append(int(size) // math.prod(sizes[axis] for axis in axes))
    return tuple(out)


def _spec_of(shape: Sequence[int], cuts: Mapping[int, Any]) -> Spec:
    return tuple(cuts.get(i) for i in range(len(shape)))


def placed_layout(mesh, state) -> Dict[str, Tuple[Spec, Tuple[int, ...], List[torch.Tensor]]]:
    """What a trainer placed, read off its TrainState: for every state
    entry (state_shardings' names) its spec, its whole (checkpoint-
    layout) shape and this rank's tensors of it. The placement is the
    trainer's record: a pipe stage's entries (mesh.pipe_stage_param_rule),
    the sharded_params layout, the dims zero2 slices over its replica
    dims, the quantized regime's flat layout, the flat update's vector;
    the tensors are what the rank holds (the parameter or buffer, and the
    optimizer's parameter, moments and EMA of it)."""
    from tensor2robot_tpu_torch.parallel import sharded_params
    from tensor2robot_tpu_torch.train import train_eval as train_eval_lib

    stage_rule = mesh_lib.pipe_stage_param_rule(mesh)
    update = state.weight_update
    sharded = update.layout if isinstance(update, train_eval_lib._ShardedParams) else {}
    out: Dict[str, Tuple[Spec, Tuple[int, ...], List[torch.Tensor]]] = {}

    def entry(name: str, tensor: torch.Tensor):
        """(spec, whole shape) of a network entry as placed."""
        if stage_rule(name) == PIPE_AXIS:
            whole = (mesh_lib.axis_size(mesh, PIPE_AXIS),) + tuple(tensor.shape)
            return _spec_of(whole, {0: PIPE_AXIS}), whole
        if name in sharded:
            whole = sharded_params.whole_shape(tensor, sharded[name], mesh)
            cuts = {d: axis for axis, d in zip((MODEL_AXIS, FSDP_AXIS), sharded[name])
                    if d is not None}
            return _spec_of(whole, cuts), tuple(whole)
        return _spec_of(tensor.shape, {}), tuple(tensor.shape)

    for name, buffer in state.network.named_buffers():
        spec, whole = entry(name, buffer)
        out[f"buffers/{name}"] = (spec, whole, [buffer])
    named = dict(state.network.named_parameters())
    for name, p in named.items():
        spec, whole = entry(name, p)
        out[f"params/{name}"] = (spec, whole, [p])

    optimizer_state = state.optimizer.state

    def moments(param: torch.Tensor) -> List[torch.Tensor]:
        return [param] + [t for t in optimizer_state.get(param, {}).values()
                          if isinstance(t, torch.Tensor) and t.ndim]

    ema = state.ema_params
    if isinstance(update, train_eval_lib._QuantizedUpdate):
        layout = update.layout
        out["opt/flat"] = ((DATA_AXIS,), (layout.padded,), moments(update.shard))
        residual = state.collective_residual
        out["residual/grad"] = ((DATA_AXIS, None), (layout.num_shards, layout.padded),
                                [residual["grad"]])
        out["residual/update"] = ((DATA_AXIS,), (layout.padded,), [residual["update"]])
        if ema is not None:
            out["ema/flat"] = ((DATA_AXIS,), (layout.padded,), [ema])
        return out
    if isinstance(update, train_eval_lib._FlatUpdate):
        flat = update.flat.flat
        spec, whole = (None,), tuple(flat.shape)
        if update.staged:  # this stage's vector: its entries and the shared ones
            spec, whole = (PIPE_AXIS, None), (mesh_lib.axis_size(mesh, PIPE_AXIS),) + whole
        out["opt/flat"] = (spec, whole, moments(flat))
        if ema is not None:
            out["ema/flat"] = (spec, whole, [ema])
        return out
    sliced = update.dims if isinstance(update, train_eval_lib._ShardedUpdate) else {}
    for name, p in named.items():
        spec, whole, _ = out[f"params/{name}"]
        held = p
        if name in sliced:
            spec = _spec_of(whole, {sliced[name]: (update.axes[0] if len(update.axes) == 1
                                                   else tuple(update.axes))})
            held = update.views[name]
        out[f"opt/{name}"] = (spec, whole, moments(held))
        if ema is not None:
            out[f"ema/{name}"] = (spec, whole, [ema[name]])
    return out


def audit_state_layout(sharding_plan: ShardingPlan, mesh, state) -> Dict[str, Any]:
    """Entry-by-entry audit of a trainer's state against the plan: every
    entry placed_layout reads off `state` must carry the spec
    `sharding_plan.state_shardings` predicts for the same whole shapes,
    and every tensor the rank holds of it must have the shape that spec
    leaves a rank (local_shape). Returns {'leaves': N, 'mismatches':
    [...]}; an empty mismatch list is the layout certificate."""
    placed = placed_layout(mesh, state)
    shapes = {key[len("params/"):]: whole for key, (_, whole, _) in placed.items()
              if key.startswith("params/")}
    buffers = {key[len("buffers/"):]: whole for key, (_, whole, _) in placed.items()
               if key.startswith("buffers/")}
    from tensor2robot_tpu_torch.train import train_eval as train_eval_lib

    predicted = sharding_plan.state_shardings(
        shapes, buffers, ema=state.ema_params is not None,
        flat=isinstance(state.weight_update, train_eval_lib._FlatUpdate))
    mismatches: List[Dict[str, str]] = []
    for key in sorted(set(predicted) | set(placed)):
        expect = predicted.get(key)
        actual = placed.get(key)
        if expect is None or actual is None:
            mismatches.append({"path": key, "actual": str(actual and actual[0]),
                               "expected": str(expect)})
            continue
        spec, whole, tensors = actual
        want = local_shape(whole, spec, mesh)
        wrong = [tuple(t.shape) for t in tensors if tuple(t.shape) != want]
        if tuple(spec) != tuple(expect) or wrong:
            mismatches.append({"path": key, "actual": str(spec), "expected": str(expect),
                               **({"shapes": f"{wrong} != {want}"} if wrong else {})})
    return {"leaves": len(set(predicted) | set(placed)), "mismatches": mismatches}
