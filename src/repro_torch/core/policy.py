"""Sparsity policies: one object per deployment scenario.

A ``SparsityPolicy`` owns three coupled decisions:

  (a) param preparation — ``prepare(model_or_params, cfg, calib_x)``:
      partial transformation, neuron-importance reconstruction, threshold
      calibration;
  (b) routing — ``route(params, x, cfg)``: which token/(sub-)expert pairs to
      compute;
  (c) execution hints — fused pipeline choice, dispatch capacity factor,
      exact capacity for batch-composition-invariant serving.

Policies are frozen dataclasses. Threshold fields (listed in ``_dynamic``)
hold Python floats or float32 tensors — scalar, or per-row (B,) for
per-request values — so a new threshold is data, never structure. The
registry maps CLI names to classes:

    none | 1t | 2t | load_aware | per_layer

``sub_pair_keep`` is the keep mask in the form the S-ETP body needs
(``core.setp``: routing already expanded to (T, K*P) sub-expert pairs);
``prepare(..., n_ep_devices=D)`` also places the sub-experts strided over
D EP devices for it.
"""
from __future__ import annotations

import dataclasses
from typing import ClassVar, Dict, Optional, Tuple, Type

import torch

from . import drop as drop_mod
from . import gating
from . import moe as moe_mod

POLICIES: Dict[str, Type["SparsityPolicy"]] = {}


def register_policy(name: str):
    def deco(cls):
        cls.name = name
        POLICIES[name] = cls
        return cls
    return deco


@dataclasses.dataclass(frozen=True)
class SparsityPolicy:
    """Base policy. Subclasses list their threshold fields in ``_dynamic``."""

    partition_p: int = 1            # partial-transformation factor P
    importance: str = "abs_gate"    # neuron-importance metric (§4.2b)
    reconstruction: bool = True     # reorder neurons before partition
    use_kernel: bool = False        # CPU: take the fused pipeline
    fused_pipeline: Optional[bool] = None   # None = auto (fused on CUDA)
    capacity_factor: float = 2.0    # dispatch-path expert capacity factor
    exact_capacity: bool = False    # capacity = T: no overflow drop ever
    drop_target: Optional[float] = None   # calibrate thresholds in prepare()

    _dynamic: ClassVar[Tuple[str, ...]] = ()
    name: ClassVar[str] = "base"
    needs_loads: ClassVar[bool] = False   # S-ETP must all-reduce a (D,)
    #                                       load histogram for the mask

    @property
    def kernel_mode_grouping(self) -> bool:
        """Group pairs by ORIGINAL expert in mode order (FULL rows first,
        MAJOR-only second) so the fused kernel skips minor-half tiles."""
        return self.partition_p > 1

    def thresholds(self) -> Tuple:
        """The policy's threshold values, in ``_dynamic`` order."""
        return tuple(getattr(self, n) for n in self._dynamic)

    # -- (a) param preparation ------------------------------------------

    def prepare_layer(self, moe_params: Dict, cfg, calib_x=None, *,
                      n_ep_devices: int = 0) -> Dict:
        """One MoE layer's param dict -> prepared dict (partition +
        reconstruction + strided placement over ``n_ep_devices``)."""
        out = moe_params
        if self.partition_p > 1:
            if calib_x is None:
                raise ValueError(f"{self.name}: prepare needs calibration "
                                 "activations to profile neuron importance")
            if self.reconstruction:
                from . import reconstruct
                out = reconstruct.partition_and_reconstruct(
                    out, calib_x, cfg, p=self.partition_p,
                    method=self.importance)
            else:
                from . import partition
                out = partition.partial_transform(out, self.partition_p)
        if n_ep_devices:
            from . import setp
            out = setp.place_params_strided(out, n_ep_devices)
        return out

    def prepare(self, target, cfg, calib_x=None, *, n_ep_devices: int = 0):
        """Prepare a model (every MoE block, replaced IN PLACE so that no
        second copy of the model's expert weights is kept) or a bare MoE
        layer dict (returned new); ``n_ep_devices`` also places the
        sub-experts strided for S-ETP. Returns ``(prepared,
        calibrated_policy)``: the policy has thresholds calibrated to
        ``drop_target`` when set."""
        kw = dict(n_ep_devices=n_ep_devices)
        if isinstance(target, dict):
            if "wg" not in target:
                return target, self
            new = self.prepare_layer(target, cfg, calib_x, **kw)
            return new, self._calibrated([new["wg"]], cfg, calib_x)
        moes = [b.moe for b in target.blocks if b.moe is not None]
        if not moes:
            return target, self
        with torch.no_grad():
            for m in moes:
                m.load_weights(self.prepare_layer(m.weights(), cfg, calib_x,
                                                  **kw))
        return target, self._calibrated([m.wg for m in moes], cfg, calib_x)

    def _calib_scores(self, wgs, cfg, calib_x):
        """(L, N, K) normalized gating scores of every layer's router."""
        return torch.stack([gating.route(calib_x, wg, cfg.top_k,
                                         cfg.router_norm_topk).norm_score
                            for wg in wgs])

    def _calibrated(self, wgs, cfg, calib_x) -> "SparsityPolicy":
        return self

    def calibrate(self, prepared, cfg, calib_x) -> "SparsityPolicy":
        """Calibrate thresholds to ``drop_target`` against already-prepared
        params without re-running the preparation."""
        if isinstance(prepared, dict):
            return self._calibrated([prepared["wg"]], cfg, calib_x)
        return self._calibrated([b.moe.wg for b in prepared.blocks
                                 if b.moe is not None], cfg, calib_x)

    # -- (b) routing -----------------------------------------------------

    def route(self, params: Dict, x, cfg, *,
              loads=None) -> drop_mod.SubExpertPairs:
        """Expanded sub-expert pairs of tokens ``x`` (T, d) under the
        layer's ``params``. ``loads``: a (D,) per-device load histogram for
        policies that read one (``load_aware``); the others ignore it."""
        raise NotImplementedError

    def sub_pair_keep(self, score, is_major, sub_idx, cfg, *, n_dev: int = 1,
                      loads=None, thresholds=None):
        """Keep mask over already-expanded (T, K*P) sub-expert pairs — the
        form the S-ETP body needs. ``loads``: the (n_dev,) all-reduced
        pre-drop histogram when ``needs_loads``; ``thresholds``: the
        layer's (2,) calibrated pair when its params carry one."""
        raise NotImplementedError

    # -- helpers ---------------------------------------------------------

    def per_token(self, batch: int, seq: int) -> "SparsityPolicy":
        """Expand per-row (B,) threshold values to per-token (B*S,) so they
        broadcast over a flattened (B*S, d) token block. Scalars pass."""
        if seq == 1:
            return self
        rep = {}
        for n in self._dynamic:
            v = getattr(self, n)
            if isinstance(v, torch.Tensor) and v.ndim == 1:
                rep[n] = torch.repeat_interleave(v, seq)
        return dataclasses.replace(self, **rep) if rep else self

    def dispatch_capacity(self, n_tokens: int) -> Optional[int]:
        """Exact-capacity hint: capacity == T, so no pair overflow-drops."""
        return n_tokens if self.exact_capacity else None


@register_policy("none")
@dataclasses.dataclass(frozen=True)
class NoDrop(SparsityPolicy):
    """No partition, no dropping: the plain top-k MoE layer."""
    partition_p: int = 1

    def route(self, params, x, cfg, *, loads=None):
        return moe_mod.route_plain(params, x, cfg)

    def sub_pair_keep(self, score, is_major, sub_idx, cfg, *, n_dev=1,
                      loads=None, thresholds=None):
        return torch.ones_like(score, dtype=torch.bool)

    @classmethod
    def from_config(cls, ds, drop_target=None, **kw):
        return cls(**kw)


@register_policy("1t")
@dataclasses.dataclass(frozen=True)
class OneTDrop(SparsityPolicy):
    """1T-Drop (§4.1): drop a token-expert pair whose normalized score is not
    above T¹ — with partition, both halves go together."""
    partition_p: int = 2
    t_drop: object = 0.08
    _dynamic: ClassVar[Tuple[str, ...]] = ("t_drop",)

    def route(self, params, x, cfg, *, loads=None):
        r = gating.route(x, params["wg"], cfg.top_k, cfg.router_norm_topk)
        return drop_mod.expand_pairs_1t(r.idx, r.combine, r.norm_score,
                                        self.partition_p, self.t_drop)

    def sub_pair_keep(self, score, is_major, sub_idx, cfg, *, n_dev=1,
                      loads=None, thresholds=None):
        return score > _bt(self.t_drop, score)

    def _calibrated(self, wgs, cfg, calib_x):
        if self.drop_target is None:
            return self
        scores = self._calib_scores(wgs, cfg, calib_x)
        return dataclasses.replace(self, t_drop=drop_mod.calibrate_threshold(
            scores, self.drop_target))

    @classmethod
    def from_config(cls, ds, drop_target=None, **kw):
        return cls(partition_p=ds.partition_p, importance=ds.importance,
                   t_drop=ds.t_drop, drop_target=drop_target, **kw)


@register_policy("2t")
@dataclasses.dataclass(frozen=True)
class TwoTDrop(SparsityPolicy):
    """2T-Drop (§4.2): below T²_major drop both halves, between compute the
    reconstructed MAJOR half only, above T²_minor compute the full expert."""
    partition_p: int = 2
    t_major: object = 0.07
    t_minor: object = 0.09
    _dynamic: ClassVar[Tuple[str, ...]] = ("t_major", "t_minor")

    def route(self, params, x, cfg, *, loads=None):
        r = gating.route(x, params["wg"], cfg.top_k, cfg.router_norm_topk)
        return drop_mod.expand_pairs_2t(r.idx, r.combine, r.norm_score,
                                        self.partition_p, self.t_major,
                                        self.t_minor)

    def sub_pair_keep(self, score, is_major, sub_idx, cfg, *, n_dev=1,
                      loads=None, thresholds=None):
        # strict > on both thresholds, as the pair expansion
        return torch.where(is_major, score > _bt(self.t_major, score),
                           score > _bt(self.t_minor, score))

    def _calibrated(self, wgs, cfg, calib_x, delta: float = 0.05):
        if self.drop_target is None:
            return self
        # calibrate in RATE space (band = ±delta around the target) so the
        # FLOPs saved equal the target: (t-δ) + ½·2δ = t
        scores = self._calib_scores(wgs, cfg, calib_x)
        tm = drop_mod.calibrate_threshold(
            scores, max(self.drop_target - delta, 0.0))
        tn = drop_mod.calibrate_threshold(
            scores, min(self.drop_target + delta, 1.0))
        return dataclasses.replace(self, t_major=tm, t_minor=tn)

    @classmethod
    def from_config(cls, ds, drop_target=None, **kw):
        return cls(partition_p=ds.partition_p, importance=ds.importance,
                   t_major=ds.t_major, t_minor=ds.t_minor,
                   drop_target=drop_target, **kw)


def _bt(t, score):
    """A threshold as a float32 tensor that broadcasts against a (T, K)
    score block: scalars pass, per-token (T,) vectors gain a pair axis."""
    t = torch.as_tensor(t, dtype=torch.float32, device=score.device)
    return t[:, None] if t.ndim == 1 else t


@register_policy("load_aware")
@dataclasses.dataclass(frozen=True)
class LoadAwareTwoT(SparsityPolicy):
    """2T-Drop with load-aware thresholds (§4.3): each EP device's T¹ steps
    down with its load ratio, so lightly-loaded devices drop less — the
    makespan (the largest device load) sets the step time anyway.

    ``n_devices`` models the EP layout on the one-card dispatch path as
    contiguous expert blocks (as ``core.load_aware`` does). Without
    ``loads`` the histogram is the batch's own pre-drop routing, every row
    of ``x`` counted. With uniform loads (or ``n_devices == 1``) this is
    exactly ``TwoTDrop(t_max - t_gap, t_max + t_gap)``."""
    partition_p: int = 2
    n_devices: int = 1
    t_max: object = 0.12
    t_gap: object = 0.01
    _dynamic: ClassVar[Tuple[str, ...]] = ("t_max", "t_gap")
    needs_loads: ClassVar[bool] = True

    def _t1(self, score, loads, dev_of):
        """Per-pair stepped-down T¹ = t_max * min(load_ratio, 1)[device]."""
        loads = loads.float()
        ratio = loads / torch.clamp(loads.mean(), min=1e-9)
        factor = torch.clamp(ratio, max=1.0)
        return _bt(self.t_max, score) * factor[dev_of]

    def route(self, params, x, cfg, *, loads=None):
        r = gating.route(x, params["wg"], cfg.top_k, cfg.router_norm_topk)
        E = params["wg"].shape[1]
        per_dev = max(E // self.n_devices, 1)
        if loads is None:
            from . import load_aware
            loads = load_aware.device_loads(
                gating.expert_histogram(r.idx, E), per_dev)
        t1 = self._t1(r.norm_score, loads, r.idx.long() // per_dev)
        gap = _bt(self.t_gap, r.norm_score)
        return drop_mod.expand_pairs_2t(
            r.idx, r.combine, r.norm_score, self.partition_p,
            torch.clamp(t1 - gap, min=0.0), t1 + gap)

    def sub_pair_keep(self, score, is_major, sub_idx, cfg, *, n_dev=1,
                      loads=None, thresholds=None):
        if loads is None:
            raise ValueError("LoadAwareTwoT.sub_pair_keep needs the "
                             "all-reduced per-device load histogram")
        t1 = self._t1(score, loads, (sub_idx % n_dev).long())  # strided
        gap = _bt(self.t_gap, score)
        return torch.where(is_major, score > torch.clamp(t1 - gap, min=0.0),
                           score > t1 + gap)

    @classmethod
    def from_config(cls, ds, drop_target=None, **kw):
        return cls(partition_p=ds.partition_p, importance=ds.importance,
                   t_max=ds.t_max, t_gap=(ds.t_minor - ds.t_major) / 2,
                   drop_target=drop_target, **kw)


@register_policy("per_layer")
@dataclasses.dataclass(frozen=True)
class PerLayerCalibrated2T(SparsityPolicy):
    """Per-layer (T²_major, T²_minor), each layer calibrated to
    ``drop_target`` on its own router's scores (beyond the paper, §5.3.3:
    one global T over-drops in deep layers, Fig. 12). ``prepare`` stores
    them in each MoE layer's params as a (2,) float32 ``thresholds``
    tensor, which ``route`` reads; the policy holds no threshold values."""
    partition_p: int = 2
    drop_target: Optional[float] = 0.25
    delta: float = 0.05

    def prepare_layer(self, moe_params, cfg, calib_x=None, *,
                      n_ep_devices: int = 0):
        out = dict(super().prepare_layer(moe_params, cfg, calib_x,
                                         n_ep_devices=n_ep_devices))
        r = gating.route(calib_x, moe_params["wg"], cfg.top_k,
                         cfg.router_norm_topk)
        target = self.drop_target if self.drop_target is not None else 0.25
        tm = drop_mod.calibrate_threshold(
            r.norm_score, max(target - self.delta, 0.0))
        tn = drop_mod.calibrate_threshold(
            r.norm_score, min(target + self.delta, 1.0))
        out["thresholds"] = torch.stack([tm, tn])
        return out

    @staticmethod
    def _layer_thresholds(th):
        if th is None:
            raise ValueError("per_layer policy: params carry no "
                             "'thresholds' — run policy.prepare() first")
        return th[0], th[1]

    def route(self, params, x, cfg, *, loads=None):
        tm, tn = self._layer_thresholds(params.get("thresholds"))
        r = gating.route(x, params["wg"], cfg.top_k, cfg.router_norm_topk)
        return drop_mod.expand_pairs_2t(r.idx, r.combine, r.norm_score,
                                        self.partition_p, tm, tn)

    def sub_pair_keep(self, score, is_major, sub_idx, cfg, *, n_dev=1,
                      loads=None, thresholds=None):
        tm, tn = self._layer_thresholds(thresholds)
        return torch.where(is_major, score > tm, score > tn)

    @classmethod
    def from_config(cls, ds, drop_target=None, **kw):
        return cls(partition_p=ds.partition_p, importance=ds.importance,
                   drop_target=0.25 if drop_target is None else drop_target,
                   **kw)


def make_policy(name: str, ds=None, *, drop_target: Optional[float] = None,
                **kw) -> SparsityPolicy:
    """Build a registered policy from a ``DualSparseConfig`` (or defaults).
    Extra kwargs (``use_kernel=``, ``exact_capacity=``, ...) set hints."""
    if name not in POLICIES:
        raise KeyError(f"unknown sparsity policy {name!r}; registered: "
                       f"{sorted(POLICIES)}")
    if ds is None:
        from ..configs.base import DualSparseConfig
        ds = DualSparseConfig()
    return POLICIES[name].from_config(ds, drop_target=drop_target, **kw)


def default_policy() -> SparsityPolicy:
    return NoDrop()


def registered_policies() -> Dict[str, Type[SparsityPolicy]]:
    """A snapshot of the policy registry (name -> class)."""
    return dict(POLICIES)


def merge_policy_override(base: Optional[SparsityPolicy],
                          override: SparsityPolicy) -> SparsityPolicy:
    """A per-request override's threshold values on the base policy's
    structure and hints. Raises when the override is another family."""
    if base is None:
        return override
    if type(override) is not type(base):
        raise ValueError(
            f"per-request policy must match the engine's policy family "
            f"{base.name!r} (got {override.name!r}); only threshold values "
            f"may differ")
    return dataclasses.replace(
        base, **{n: getattr(override, n) for n in base._dynamic})
