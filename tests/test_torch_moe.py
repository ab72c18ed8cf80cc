"""The port's MoE FFN (``repro_torch.models.layers.moe_ffn`` /
``moe_route``) against the reference's ``moe_ffn``, in fp32 at smoke
widths (8 experts, top-2, one shared expert).

Params come from the reference's own ``init_tree`` of its MoE specs,
tokens from a seed with numpy.  The output agrees within ``1e-5`` of its
scale and the aux loss within ``1e-6`` relative; with the published
capacity factor and a router column biased towards expert 0 the test
recomputes the experts' loads in numpy and asserts that assignments are
dropped, so the overflow path is what is compared.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as RL
from repro_torch.configs import smoke_config
from repro_torch.models import layers as L
from repro_torch.models.config import ParallelConfig
from repro_torch.models.model import Model, build_segments, model_specs

SMOKE = smoke_config("deepseek-moe-16b")  # 8 experts, top-2, 1 shared, cf 8.0 (dropless)


def moe_case(cf: float, bias: float, seed: int = 0):
    cfg = dataclasses.replace(SMOKE, capacity_factor=cf)
    params = jax.tree.map(np.asarray, RL.init_tree(RL.moe_specs(cfg), jax.random.PRNGKey(seed)))
    params["router"] = params["router"].copy()
    params["router"][:, 0] += bias
    x = np.random.default_rng(seed).standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    return cfg, params, x


def expected_keep(expert_idx: np.ndarray, cap: int) -> np.ndarray:
    """(G, Ng*k) keep mask in the stable expert-major order, from numpy."""
    out = []
    for flat in expert_idx.reshape(expert_idx.shape[0], -1):
        order = np.argsort(flat, kind="stable")
        se = flat[order]
        pos = np.arange(len(se)) - np.searchsorted(se, se, side="left")
        out.append(pos < cap)
    return np.stack(out)


@pytest.mark.parametrize("n_groups", [1, 2])
@pytest.mark.parametrize("case", ["dropless", "overflow"])
def test_moe_ffn_equals_the_reference(case, n_groups):
    cf, bias = (8.0, 0.0) if case == "dropless" else (1.25, 3.0)
    cfg, params, x = moe_case(cf, bias)
    r_out, r_aux = jax.jit(RL.moe_ffn, static_argnames=("cfg", "n_groups"))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x), cfg=cfg, n_groups=n_groups)
    p = {k: torch.from_numpy(np.array(v)) for k, v in params.items()}
    xt = torch.from_numpy(x)
    out, aux = L.moe_ffn(p, xt, cfg, n_groups=n_groups)
    scale = float(np.abs(np.asarray(r_out)).max())
    np.testing.assert_allclose(out.numpy(), np.asarray(r_out), rtol=0, atol=1e-5 * scale)
    np.testing.assert_allclose(float(aux), float(r_aux), rtol=1e-6)

    # the routing: top-k as jax.lax.top_k gives it, the keep mask from numpy
    g = n_groups
    r = L.moe_route(p, xt.reshape(g, -1, cfg.d_model), cfg)
    logits = (jnp.asarray(x).reshape(g, -1, cfg.d_model) @ jnp.asarray(params["router"]))
    _, r_idx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), cfg.top_k)
    np.testing.assert_array_equal(r.expert_idx.numpy(), np.asarray(r_idx))
    ng = x.shape[0] * x.shape[1] // g
    cap = min(max(math.ceil(ng * cfg.top_k / cfg.n_experts * cf), 8), ng * cfg.top_k)
    assert r.cap == cap
    np.testing.assert_array_equal(r.keep.numpy(), expected_keep(np.asarray(r_idx), cap))
    loads = np.stack([np.bincount(row.reshape(-1), minlength=cfg.n_experts)
                      for row in np.asarray(r_idx)])
    kept = np.minimum(loads, cap).sum()
    assert int(r.keep.sum()) == kept
    if case == "overflow":
        assert loads.max() > cap and kept < loads.sum(), (loads, cap)
    else:
        assert loads.max() <= cap


def test_top_k_ties_take_the_lower_index():
    """A zero router makes every probability equal: the top-2 are experts
    0 and 1 in both packages (jax.lax.top_k's tie order), and all of them
    route the same way."""
    cfg, params, x = moe_case(8.0, 0.0)
    params["router"] = np.zeros_like(params["router"])
    p = {k: torch.from_numpy(np.array(v)) for k, v in params.items()}
    r = L.moe_route(p, torch.from_numpy(x).reshape(1, -1, cfg.d_model), cfg)
    _, r_idx = jax.lax.top_k(jnp.full((1, 48, cfg.n_experts), 1 / cfg.n_experts), cfg.top_k)
    np.testing.assert_array_equal(r.expert_idx.numpy(), np.asarray(r_idx))
    assert (r.expert_idx.numpy() == [0, 1]).all()
    out, _ = L.moe_ffn(p, torch.from_numpy(x), cfg)
    r_out, _ = jax.jit(RL.moe_ffn, static_argnames="cfg")(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x), cfg=cfg)
    scale = float(np.abs(np.asarray(r_out)).max())
    np.testing.assert_allclose(out.numpy(), np.asarray(r_out), rtol=0, atol=1e-5 * scale)


def test_moe_specs_equal_the_references():
    for shared in (0, 1):
        cfg = dataclasses.replace(SMOKE, n_shared_experts=shared)
        got, want = L.moe_specs(cfg), RL.moe_specs(cfg)
        assert list(got) == list(want)
        assert all(got[k].shape == want[k].shape for k in want)


def test_moe_init_keeps_the_stacked_fan_in_of_the_expert_leaves():
    """13 layers: layer 0 dense and unscanned, layers 1-12 one scanned
    segment of MoE blocks.  The reference's tree and shapes; each
    stacked leaf, the 4-D expert leaves (12, E, D, F) included, has std
    1/sqrt(12); the unscanned dense layer's 1/sqrt(input width)."""
    from repro.configs import smoke_config as r_smoke
    from repro.models.config import ParallelConfig as RParallelConfig
    from repro.models.model import Model as RModel

    cfg = dataclasses.replace(SMOKE, n_layers=13)
    r_shapes = jax.tree_util.tree_flatten_with_path(
        RModel(dataclasses.replace(r_smoke("deepseek-moe-16b"), n_layers=13),
               RParallelConfig()).param_shapes(),
        is_leaf=lambda t: isinstance(t, tuple))[0]
    m = Model(cfg, ParallelConfig(), device="cpu")
    assert m.param_shapes() == {
        ".".join(str(k.key) for k in path): shp for path, shp in r_shapes}
    assert [(s.scanned, s.n_groups, s.first_layer) for s in m.segments] == [
        (False, 1, 0), (True, 12, 1)]
    assert "mlp" in m.layers[0] and "moe" not in m.layers[0]
    assert all("moe" in m.layers[i] for i in range(1, 13))

    m.init(torch.Generator().manual_seed(0))
    for leaf in ("router", "we_gate", "we_up", "we_down", "ws_gate", "ws_down"):
        vals = torch.stack([m.layers[i]["moe"][leaf] for i in range(1, 13)])
        assert abs(float(vals.std()) * np.sqrt(12) - 1) < 0.05, leaf
    w = m.layers[0]["mlp"]["w_gate"]
    assert abs(float(w.std()) * np.sqrt(cfg.d_model) - 1) < 0.05
    # published: 27 scanned MoE layers -> every expert leaf's std 1/sqrt(27)
    from repro_torch.configs import get_config

    full = get_config("deepseek-moe-16b")
    spec = model_specs(full, build_segments(full))["seg1"]["b0"]["moe"]["we_gate"]
    assert spec.shape == (27, 64, 2048, 1408) and abs(spec.std() - 1 / np.sqrt(27)) < 1e-12


def test_published_capacity_drops_in_the_forward_and_matches_the_reference():
    """The published factor 1.25 on the smoke MoE: a teacher-forced
    forward over 2 x 28 tokens drops assignments at capacity (the keep
    masks say so), and the port's logits and aux loss still equal the
    reference's; decode equals the forward only without drops
    (``ROADMAP.md`` §3)."""
    from repro.configs import smoke_config as r_smoke
    from repro.models.config import ParallelConfig as RParallelConfig
    from repro.models.model import Model as RModel
    from repro_torch.models.interop import params_from_reference

    rcfg = dataclasses.replace(r_smoke("deepseek-moe-16b"), capacity_factor=1.25)
    rm = RModel(rcfg, RParallelConfig(), compute_dtype=jnp.float32, q_chunk=8, kv_chunk=8)
    params = rm.init(jax.random.PRNGKey(0))
    toks = np.random.default_rng(0).integers(0, rcfg.vocab_size, (2, 28)).astype(np.int32)
    r_logits, r_aux = jax.jit(rm.forward)(params, dict(tokens=jnp.asarray(toks)))

    cfg = dataclasses.replace(SMOKE, capacity_factor=1.25)
    pm = Model(cfg, ParallelConfig(), compute_dtype=torch.float32, q_chunk=8, kv_chunk=8,
               device="cpu")
    params_from_reference(pm, jax.tree.map(np.asarray, params))
    seen = []
    route = L.moe_route

    def recording(*args):
        r = route(*args)
        seen.append(r)
        return r

    L.moe_route = recording
    try:
        with torch.no_grad():
            logits, aux = pm.forward(dict(tokens=torch.as_tensor(toks, dtype=torch.int64)))
    finally:
        L.moe_route = route
    assert len(seen) == 1 and int((~seen[0].keep).sum()) > 0
    np.testing.assert_allclose(logits.numpy(), np.asarray(r_logits), atol=1e-4, rtol=0)
    np.testing.assert_allclose(float(aux), float(r_aux), rtol=1e-6)


@pytest.mark.parametrize("n_groups", [1, 2])
@pytest.mark.parametrize("case", ["dropless", "overflow"])
def test_routing_counts_equal_the_in_place_forms_bit_for_bit(case, n_groups):
    """The expert counts of the aux loss (an out-of-place ``index_add``)
    and each assignment's capacity slot (an exclusive prefix sum of the
    group's counts, in place of a ``searchsorted`` DTensor cannot shard)
    equal the in-place ``index_add_`` and the ``searchsorted`` forms bit
    for bit on the CPU."""
    cf, bias = (8.0, 0.0) if case == "dropless" else (1.25, 3.0)
    cfg, params, x = moe_case(cf, bias)
    p = {k: torch.from_numpy(np.array(v)) for k, v in params.items()}
    xt = torch.from_numpy(x).reshape(n_groups, -1, cfg.d_model)
    r = L.moe_route(p, xt, cfg)
    g, ng, _ = xt.shape
    e, k = cfg.n_experts, cfg.top_k
    flat = r.expert_idx.reshape(-1)
    ce = torch.zeros(e).index_add_(0, flat, torch.ones(flat.shape))
    aux = e * torch.sum(r.probs.mean((0, 1)) * (ce / (g * ng * k)))
    assert torch.equal(r.aux_loss, aux)
    se = r.expert_idx.reshape(g, ng * k).gather(1, r.order)
    run_start = torch.searchsorted(se, torch.arange(e).expand(g, e).contiguous(), side="left")
    pos = torch.arange(ng * k) - run_start.gather(1, se)
    assert torch.equal(r.keep, pos < r.cap)
    assert torch.equal(r.dst, se * r.cap + torch.where(pos < r.cap, pos, 0))
    assert (case == "overflow") == bool((~r.keep).any())
