"""The port's meta-tensor stand-ins (``launch.input_specs``) against
``jax.eval_shape`` of the JAX package's, at full width for every arch: the
params, the optimizer state, the caches and each cell's kwargs tree, shape
and dtype of every leaf. A stacked JAX block leaf (L, ...) is the port's L
per-layer leaves (...)."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.configs import ARCHS as JAX_ARCHS  # noqa: E402
from repro.launch import input_specs as jspecs  # noqa: E402
from repro_torch.configs import ARCHS, SHAPES, cell_supported  # noqa: E402
from repro_torch.launch import input_specs as specs  # noqa: E402
from repro_torch.models import model as M  # noqa: E402


def _dtype(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).removeprefix("torch.")
    return leaf.dtype.name


def _leaves(tree, prefix=()):
    """{path: (shape, dtype)} of a tree of tensors or ShapeDtypeStructs."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, prefix + (k,)))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_leaves(v, prefix + (i,)))
        return out
    return {prefix: (tuple(tree.shape), _dtype(tree))}


def _unstacked(jax_params, n_layers):
    """The JAX params with ``blocks`` split into the port's per-layer list."""
    out = {k: v for k, v in jax_params.items() if k != "blocks"}
    layer = jax.tree.map(lambda s: jax.ShapeDtypeStruct(s.shape[1:], s.dtype),
                         jax_params["blocks"])
    out["blocks"] = [layer] * n_layers
    return out


@pytest.fixture(autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_param_and_opt_structs_equal_eval_shape(arch):
    cfg, jcfg = ARCHS[arch], JAX_ARCHS[arch]
    params = specs.param_structs(cfg)
    jparams = jspecs.param_structs(jcfg)
    assert all(t.device.type == "meta" for t in jax.tree.leaves(
        params, is_leaf=lambda x: isinstance(x, torch.Tensor)))
    assert len(params["blocks"]) == cfg.n_layers
    assert all(leaf.shape[0] == cfg.n_layers for leaf in jax.tree.leaves(jparams["blocks"]))
    want = _leaves(_unstacked(jparams, cfg.n_layers))
    assert _leaves(params) == want
    opt, jopt = specs.opt_structs(cfg), jspecs.opt_structs(jcfg)
    assert _leaves(opt) == _leaves({"m": _unstacked(jopt["m"], cfg.n_layers),
                                    "v": _unstacked(jopt["v"], cfg.n_layers),
                                    "step": jopt["step"]})


@pytest.mark.parametrize("arch", list(ARCHS))
def test_cache_structs_and_input_specs_equal_eval_shape(arch):
    cfg, jcfg = ARCHS[arch], JAX_ARCHS[arch]
    kv_dtypes = ("bfloat16",) if cfg.family == "hybrid" else ("bfloat16", "int8")
    for kv in kv_dtypes:
        c = dataclasses.replace(cfg, kv_cache_dtype=kv)
        jc = dataclasses.replace(jcfg, kv_cache_dtype=kv)
        for batch, max_len in ((128, 32768), (1, 4096), (3, 100)):
            assert (_leaves(specs.cache_structs(c, batch, max_len))
                    == _leaves(jspecs.cache_structs(jc, batch, max_len)))
    for shape in SHAPES:
        if not cell_supported(cfg, shape)[0]:
            continue
        got, want = specs.input_specs(cfg, shape), jspecs.input_specs(jcfg, shape)
        assert sorted(got) == sorted(want)
        assert _leaves(got) == _leaves(want)


def test_meta_init_draws_nothing_and_cpu_init_is_unchanged():
    """init_params on the meta device takes no generator and draws nothing;
    on the CPU the same seed still gives the same weights."""
    cfg = ARCHS["zamba2-1.2b"].reduced()
    state = torch.random.get_rng_state()
    meta = M.init_params(cfg, device="meta")
    assert torch.equal(torch.random.get_rng_state(), state)
    a = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    b = M.init_params(cfg, device="cpu")
    for (pa, ta), (pb, tb), (pm, tm) in zip(_leaves_t(a), _leaves_t(b), _leaves_t(meta),
                                            strict=True):
        assert pa == pb == pm
        assert torch.equal(ta, tb)
        assert tm.shape == ta.shape and tm.dtype == ta.dtype and tm.is_meta


def _leaves_t(tree, prefix=()):
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _leaves_t(v, prefix + (k,))]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree) for x in _leaves_t(v, prefix + (i,))]
    return [(prefix, tree)]
