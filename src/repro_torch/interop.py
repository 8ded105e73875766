"""Carry problem, algorithm state and model weights over from the JAX
package.

What crosses over is the problem (params, step rule, trace, overlay,
pool, a compiled scenario, a sweep grid), the algorithm state (duals and
visit counts), the cloudlet LM's weights, a training state (weights,
optimizer moments, step), the trained classifier pair and the gain tier
(the predictor, the ridge and SSD gain models, the gain sources).  Each
function takes the reference's object with numpy leaves — or any object with the same attributes — and builds the port's
object on ``device``, so a run can start in one package and continue in
the other, and both packages can compute the same function in the tests.
Nothing here imports JAX: callers convert leaves with ``np.asarray``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.fleet import RawOverlay, Trace
from repro_torch.core.onalgo import OnAlgoParams, OnAlgoState, StepRule
from repro_torch.core.state_space import RhoEstimator
from repro_torch.models.lm import to_module
from repro_torch.serve.simulator import PrecomputedPool
from repro_torch.topology import StreamingAssoc, Topology


def _t(x, dtype, device):
    return torch.tensor(np.asarray(x), dtype=dtype, device=device)


def step_rule_from(rule) -> StepRule:
    """``StepRule`` from an object with scalar ``a`` and ``beta``."""
    return StepRule(a=float(np.asarray(rule.a)),
                    beta=float(np.asarray(rule.beta)))


def onalgo_params_from(params, *, device) -> OnAlgoParams:
    """``OnAlgoParams`` from ``B`` (N,), ``H`` () and ``precondition``."""
    return OnAlgoParams(B=_t(params.B, torch.float32, device),
                        H=_t(params.H, torch.float32, device),
                        precondition=bool(params.precondition))


def onalgo_state_from(state, *, device) -> OnAlgoState:
    """``OnAlgoState`` from ``lam`` (N,), ``mu`` () or (K,) (a topology's
    per-cloudlet duals) and ``rho.counts`` (N, M) / ``rho.t`` ()."""
    return OnAlgoState(
        lam=_t(state.lam, torch.float32, device),
        mu=_t(state.mu, torch.float32, device),
        rho=RhoEstimator(counts=_t(state.rho.counts, torch.float32, device),
                         t=int(np.asarray(state.rho.t))))


def topology_from(topo, *, device) -> Topology:
    """``Topology`` from ``assoc`` ((N,) or (T, N) ids), ``H_k`` (K,) and
    ``K``.  A streaming association (``topo.streaming``) carries over as a
    :class:`StreamingAssoc` from its ``entry`` (n_blocks, N) boundary
    states, ``p_handover``, ``seed`` and ``T``, ``N``, ``K``."""
    assoc = topo.assoc
    if getattr(topo, "streaming", False):
        assoc = StreamingAssoc(
            entry=_t(assoc.entry, torch.int32, device),
            p_handover=float(np.float32(np.asarray(assoc.p_handover))),
            seed=int(np.asarray(assoc.seed)), T=int(assoc.T),
            N=int(assoc.N), K=int(assoc.K))
    else:
        assoc = _t(assoc, torch.int32, device)
    return Topology(assoc=assoc, H_k=_t(topo.H_k, torch.float32, device),
                    K=int(topo.K))


def trace_from(trace, *, device) -> Trace:
    """``Trace`` from ``j_idx`` (T, N) and ``d_local`` (T, N)."""
    return Trace(j_idx=_t(trace.j_idx, torch.int32, device),
                 d_local=_t(trace.d_local, torch.float32, device))


def raw_overlay_from(overlay, *, device) -> RawOverlay:
    """``RawOverlay`` from the five (T, N) raw-value streams."""
    return RawOverlay(*(_t(getattr(overlay, k), torch.float32, device)
                        for k in ("o", "h", "w", "correct_local",
                                  "correct_cloud")))


def pool_from(pool) -> PrecomputedPool:
    """``PrecomputedPool`` (numpy arrays, as the reference holds them)."""
    return PrecomputedPool(*(np.asarray(getattr(pool, k)) for k in (
        "local_correct", "cloud_correct", "d_local", "phi_hat", "sigma",
        "cycles")))


def _weight(x, device) -> torch.Tensor:
    """A numpy leaf as a tensor of the same dtype (a bfloat16 leaf, which
    numpy holds as ml_dtypes.bfloat16, goes through float32: exact)."""
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":
        return torch.tensor(x.astype(np.float32), device=device).to(
            torch.bfloat16)
    return torch.tensor(x, device=device)


def _tree(t, device, pick=lambda x: x):
    if isinstance(t, dict):
        return {k: _tree(v, device, pick) for k, v in t.items()}
    return _weight(pick(t), device)


def _unstack(t, n: int, device) -> list:
    """A tree stacked on a leading axis of n -> n trees."""
    return [_tree(t, device, lambda x, i=i: np.asarray(x)[i])
            for i in range(n)]


def model_params_from(params, cfg, *, device):
    """The port's LM params (``models.lm.init_lm``'s module) from the
    reference's params tree with numpy leaves: {"embed", "blocks",
    "final_norm"}, the blocks stacked on a leading axis of
    ``cfg.num_layers // cfg.pattern_period`` pattern instances
    (``repro/models/lm.py::init_lm``), which becomes the module list.
    Each instance carries its sub-blocks as they are ("sub0" ... for a
    period-8 Jamba pattern; an MoE sub-block's "ffn" holds "router",
    "w_up", "w_gate", "w_down", Arctic's also "ffn_dense")."""
    n_scan = cfg.num_layers // cfg.pattern_period
    return to_module({"embed": _tree(params["embed"], device),
                      "blocks": _unstack(params["blocks"], n_scan, device),
                      "final_norm": _tree(params["final_norm"], device)})


def encdec_params_from(params, cfg, *, device):
    """The port's encoder-decoder params (``models.encdec.init_encdec``'s
    module) from the reference's tree with numpy leaves: {"embed",
    "encoder", "decoder", "enc_norm", "final_norm"}, the encoder and
    decoder stacked on a leading layer axis (``cfg.enc_layers`` /
    ``cfg.num_layers``), which become module lists."""
    return to_module({
        "embed": _tree(params["embed"], device),
        "encoder": _unstack(params["encoder"], cfg.enc_layers, device),
        "decoder": _unstack(params["decoder"], cfg.num_layers, device),
        "enc_norm": _tree(params["enc_norm"], device),
        "final_norm": _tree(params["final_norm"], device)})


def scenario_from(sc):
    """The port's ``Scenario`` from the reference's (plain data: the same
    fields)."""
    from repro_torch.scenarios import Scenario
    return Scenario.from_dict(sc.to_dict())


def compiled_scenario_from(c, *, device):
    """The port's ``CompiledScenario`` from the reference's, leaves as numpy
    arrays: trace, tables, params, ``true_rho``, ``meta`` (copied) and the
    topology."""
    from repro_torch.scenarios import CompiledScenario
    return CompiledScenario(
        scenario=scenario_from(c.scenario),
        trace=trace_from(c.trace, device=device),
        tables=tuple(_t(x, torch.float32, device) for x in c.tables),
        params=onalgo_params_from(c.params, device=device),
        true_rho=(None if c.true_rho is None
                  else _t(c.true_rho, torch.float32, device)),
        meta=dict(c.meta),
        topology=(None if c.topology is None
                  else topology_from(c.topology, device=device)))


def sweep_grid_from(grid, *, device):
    """The port's ``SweepGrid`` from the reference's: stacked ``rules``
    (``a``, ``beta`` (G,)), stacked ``params`` (``B`` (G, N), ``H`` (G,),
    ``precondition``) and ``labels``."""
    from repro_torch.scenarios.sweeps import StackedRules, SweepGrid
    return SweepGrid(
        rules=StackedRules(a=np.asarray(grid.rules.a, np.float32),
                           beta=np.asarray(grid.rules.beta, np.float32)),
        params=onalgo_params_from(grid.params, device=device),
        labels=tuple(grid.labels))


def gain_predictor_from(pred):
    """The port's numpy ``GainPredictor`` from the reference's fields
    (``class_specific``, ``l2``, ``coefs``, ``sigma``, ``num_classes``)."""
    from repro_torch.data.predictor import GainPredictor
    return GainPredictor(
        class_specific=bool(pred.class_specific), l2=float(pred.l2),
        coefs=None if pred.coefs is None else np.asarray(pred.coefs),
        sigma=None if pred.sigma is None else np.asarray(pred.sigma),
        num_classes=int(pred.num_classes))


def ridge_gain_model_from(model, *, device):
    """``RidgeGainModel`` from ``coefs`` (C, F+1) and ``sigma`` (C,)."""
    from repro_torch.gain.model import RidgeGainModel
    return RidgeGainModel(coefs=_t(model.coefs, torch.float32, device),
                          sigma=_t(model.sigma, torch.float32, device))


def seq_gain_model_from(model, *, device):
    """``SeqGainModel`` from the reference's: its config's dims, its
    params tree ({"w_feat", "b_feat", "mamba": the mixer's leaves by the
    names ``models.ssm.init_ssm`` gives them, "w_head", "b_head"}, leaves
    as tensors of their dtype) and its per-class ``sigma``."""
    from repro_torch.gain.model import SeqGainConfig, SeqGainModel
    c = model.cfg
    cfg = SeqGainConfig(**{k: int(getattr(c, k)) for k in (
        "feat_dim", "d_model", "d_inner", "ssm_state", "ssm_ngroups",
        "ssm_heads", "ssm_headdim", "ssm_conv_kernel")})

    return SeqGainModel(cfg=cfg, params=_tree(model.params, device),
                        sigma=_t(model.sigma, torch.float32, device))


def gain_source_from(src, *, device):
    """The port's gain source from the reference's: ``TableGain`` and
    ``OverlayGain`` as they are; a ``ModelGain`` with its model carried
    over (a ridge model by its ``coefs``, the SSD head by its ``params``),
    its ``local_probs`` and ``quantize``."""
    from repro_torch.gain import source as gs
    kind = type(src).__name__
    if kind in ("TableGain", "OverlayGain"):
        return getattr(gs, kind)()
    if kind != "ModelGain":
        raise TypeError(f"not a gain source of the reference: {src!r}")
    model = (ridge_gain_model_from(src.model, device=device)
             if hasattr(src.model, "coefs")
             else seq_gain_model_from(src.model, device=device))
    return gs.ModelGain(model=model, local_probs=np.asarray(src.local_probs),
                        quantize=bool(src.quantize))


def _ref_leaves(tree, prefix="") -> dict:
    """{"a/b/c": leaf} of a reference tree of nested dicts (its path
    names, as ``train.tree.ref_key`` gives them)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_ref_leaves(v, f"{prefix}/{k}" if prefix else str(k)))
        return out
    return {prefix: tree}


def train_state_from(state, params, *, device):
    """The port's ``train.trainer.TrainState`` from the reference's, its
    leaves numpy: ``params`` is the port's parameter tree already carried
    across (``model_params_from`` / ``encdec_params_from`` / a dict of
    tensors), made trainable in place; the optimizer state (AdamW's "m",
    "v", Adafactor's "v" with its factored "vr" / "vc", "count") is
    unstacked onto the port's parameter names (``train.tree.ref_key``);
    ``step`` an int32 scalar."""
    from repro_torch.train.trainer import TrainState
    from repro_torch.train.tree import named_leaves, ref_key

    names = named_leaves(params)
    for p in names.values():
        p.requires_grad_(True)
    opt = state.opt_state

    def per_name(tree):
        flat = _ref_leaves(tree)
        out = {}
        for name in names:
            path, index = ref_key(name.split("."))
            if path in flat:
                out[name] = _weight(np.asarray(flat[path])[index], device)
            else:  # Adafactor's factored entries under the leaf's path
                out[name] = {k[len(path) + 1:]: _weight(
                    np.asarray(v)[index], device) for k, v in flat.items()
                    if k.startswith(path + "/")}
        return out

    opt_state = {k: per_name(v) for k, v in opt.items() if k != "count"}
    opt_state["count"] = _t(opt["count"], torch.int32, device)
    return TrainState(params=params, opt_state=opt_state,
                      step=_t(state.step, torch.int32, device))


def mlp_params_from(params, *, device):
    """The port's ``data.synthetic.MLP`` from the reference's params list
    of {"w" (d_in, d_out), "b" (d_out,)}."""
    from repro_torch.data.synthetic import MLP
    return MLP([(_weight(layer["w"], device), _weight(layer["b"], device))
                for layer in params])


def classifier_pair_from(pair, *, device):
    """The port's ``ClassifierPair`` from the reference's (its two MLPs'
    params and accuracies)."""
    from repro_torch.data.synthetic import ClassifierPair
    return ClassifierPair(
        local_params=mlp_params_from(pair.local_params, device=device),
        cloud_params=mlp_params_from(pair.cloud_params, device=device),
        local_acc=float(pair.local_acc), cloud_acc=float(pair.cloud_acc))
