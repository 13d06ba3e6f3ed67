"""Channel dependency graph for structural pruning.

The port's own copy of ``diff_pruning_tpu/pruning/graph.py`` (pure Python,
same classes and fields), so the port imports nothing of the JAX package;
``tests/test_torch_unet.py`` holds the two graphs equal field by field.
``validate`` reads params through the port's ``surgery.get_path``.

Redesign of torch_pruning's ``DependencyGraph``
(reference: ddpm_exp/torch_pruning/dependency.py). The reference discovers
channel couplings by walking torch's autograd ``grad_fn`` graph after a
forward pass. Here, models are pure functions over parameter pytrees, and we
control the model zoo, so the graph is constructed *while the model is
defined*: every prunable channel dimension in the network is a
:class:`ChannelVar`, and every parameter axis that is indexed by one (or, for
concatenated inputs, several) of those vars registers an :class:`AxisRef`.

This replaces, exactly and by construction:
  - residual-add coupling (both sides share one ChannelVar),
  - skip-concat index offsets (``_ConcatIndexMapping``,
    dependency.py:946-989): an AxisRef carries ``(var, offset)`` parts,
  - GroupNorm channel grouping (metapruner.py:117-124): ``group_div`` on the
    var forces uniform pruning across the GN groups,
  - attention-head grouping (ldm_prune.py:75-81): likewise via ``group_div``.

Pruning then is: score each var (importance.py) -> select keep-indices per
var under its constraints (pruner.py) -> functionally slice every registered
param axis (surgery.py) -> emit a new config carrying the per-var channel
sizes, so the pruned model round-trips through a clean (config, params)
checkpoint instead of the reference's whole-module pickles
(ddpm_prune.py:135).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple, Union


@dataclasses.dataclass
class ChannelVar:
    """One prunable channel dimension shared by every tensor that carries it."""

    name: str
    size: int
    prunable: bool = True
    # Channels must be pruned uniformly across `group_div` equal contiguous
    # blocks (GroupNorm groups / attention heads). Mirrors torch_pruning's
    # channel_groups semantics (metapruner.py:237-246).
    group_div: int = 1
    # Pruned-away count is rounded down to a multiple of this
    # (metapruner.py:232-233; ldm_exp/prune_ldm.py:99 uses round_to=2).
    round_to: int = 1

    def require_group_div(self, g: int) -> None:
        """Tighten the grouping constraint (lcm so GN(32) + heads compose)."""
        self.group_div = self.group_div * g // math.gcd(self.group_div, g)


@dataclasses.dataclass(frozen=True)
class CatVar:
    """A channel dimension formed by concatenating several ChannelVars.

    Used for UNet up-block inputs ``concat([h, skip])``
    (diffusers/models/unet_2d_blocks.py:1822). Not itself prunable — pruning
    its parts implies slicing consumers at the right offsets.
    """

    parts: Tuple[ChannelVar, ...]

    @property
    def size(self) -> int:
        return sum(p.size for p in self.parts)


VarLike = Union[ChannelVar, CatVar]


def _parts_of(v: VarLike) -> Tuple[Tuple[ChannelVar, int], ...]:
    """Expand a var (or concat of vars) into (var, offset) parts."""
    if isinstance(v, ChannelVar):
        return ((v, 0),)
    out = []
    off = 0
    for p in v.parts:
        out.append((p, off))
        off += p.size
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class AxisRef:
    """One parameter axis indexed by channel var(s).

    ``parts`` maps contiguous index ranges of the axis to vars:
    ``[(var, offset), ...]`` where ``param[..., offset : offset+var.size, ...]``
    along ``axis`` is indexed by ``var``.

    ``role`` drives importance semantics (importance.py):
      'out'  — producing axis (conv cout / linear out / embedding dim)
      'in'   — consuming axis (conv cin / linear in)
      'norm' — norm scale (GN/LN gamma)
      'bias' — bias vectors (excluded from importance, sliced in surgery,
               matching torch_pruning which scores only .weight)
    """

    param: str  # '/'-joined path into the params pytree
    axis: int
    parts: Tuple[Tuple[ChannelVar, int], ...]
    role: str  # 'out' | 'in' | 'norm' | 'bias'


class ChannelGraph:
    """Registry of ChannelVars and the parameter axes they index."""

    def __init__(self) -> None:
        self.vars: Dict[str, ChannelVar] = {}
        self.refs: List[AxisRef] = []
        # var name -> list of refs that touch it (built lazily)
        self._by_var: Optional[Dict[str, List[Tuple[AxisRef, int]]]] = None

    # -- construction ------------------------------------------------------

    def var(
        self,
        name: str,
        size: int,
        *,
        prunable: bool = True,
        group_div: int = 1,
        round_to: int = 1,
    ) -> ChannelVar:
        if name in self.vars:
            raise ValueError(f"duplicate ChannelVar {name!r}")
        v = ChannelVar(name, size, prunable=prunable, group_div=group_div, round_to=round_to)
        self.vars[name] = v
        return v

    def ref(self, param: str, axis: int, var: VarLike, role: str) -> None:
        if role not in ("out", "in", "norm", "bias"):
            raise ValueError(f"bad role {role!r}")
        self.refs.append(AxisRef(param, axis, _parts_of(var), role))
        self._by_var = None

    # -- queries -----------------------------------------------------------

    def refs_of(self, var: ChannelVar) -> List[Tuple[AxisRef, int]]:
        """All (ref, offset) pairs whose axis includes `var`."""
        if self._by_var is None:
            by: Dict[str, List[Tuple[AxisRef, int]]] = {}
            for r in self.refs:
                for v, off in r.parts:
                    by.setdefault(v.name, []).append((r, off))
            self._by_var = by
        return self._by_var.get(var.name, [])

    def prunable_vars(self) -> List[ChannelVar]:
        return [v for v in self.vars.values() if v.prunable]

    def summary(self) -> str:
        """Human-readable group listing (torch_pruning's get_all_groups /
        print(group) analog): one line per var with size, constraints, and
        the params whose axes it indexes."""
        lines = []
        for v in self.vars.values():
            tags = []
            if not v.prunable:
                tags.append("fixed")
            if v.group_div > 1:
                tags.append(f"group_div={v.group_div}")
            if v.round_to > 1:
                tags.append(f"round_to={v.round_to}")
            refs = self.refs_of(v)
            lines.append(f"{v.name} [{v.size}]{' (' + ', '.join(tags) + ')' if tags else ''}"
                         f" <- {len(refs)} param axes")
            for ref, off in refs:
                lines.append(f"    {ref.role:4s} {ref.param} axis={ref.axis}"
                             + (f" offset={off}" if off else ""))
        return "\n".join(lines)

    def validate(self, params) -> None:
        """Check every ref is consistent with actual param shapes."""
        from .surgery import get_path  # local import to avoid cycle

        for r in self.refs:
            arr = get_path(params, r.param)
            total = sum(v.size for v, _ in r.parts)
            if arr.shape[r.axis] != total:
                raise ValueError(
                    f"{r.param} axis {r.axis} has size {arr.shape[r.axis]}, "
                    f"graph says {total} ({[(v.name, v.size) for v, _ in r.parts]})"
                )
