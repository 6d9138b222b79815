"""The PyTorch port's vlm and audio backbones against the JAX package's.

internvl2-76b and musicgen-medium reduced, at float32, with one set of
weights (the JAX params as numpy, bridged by ``params_from_numpy``): a
forward and a prefill from frontend embeddings (B,S,D) through
``frontend_proj``, then decode from token ids, as the JAX package serves
them; logits and K/V within 1e-4. Then the serving CLI on the CPU for the
four archs that the port serves since the MoE and frontend families came
in.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import model as M  # noqa: E402

TOL = 1e-4
ARCHS = ["internvl2-76b", "musicgen-medium"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes on the
    cores (xdist), and many small tensor ops slow down tenfold when each
    process also spreads them over every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=ARCHS)
def bridged(request):
    jcfg, cfg = (dataclasses.replace(get(request.param).reduced(), dtype="float32")
                 for get in (jax_get_config, get_config))
    np_params = jax.tree.map(np.asarray, JM.init_params(jax.random.key(0), jcfg))
    return jcfg, cfg, jax.tree.map(jnp.asarray, np_params), M.params_from_numpy(
        np_params, cfg, device="cpu")


def _embeds(cfg, shape, seed):
    return np.random.default_rng(seed).normal(size=(*shape, cfg.d_model)).astype(np.float32)


def _close(got, want):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=TOL, rtol=TOL)


def test_frontend_proj(bridged):
    jcfg, cfg, jparams, params = bridged
    assert cfg.frontend != "tokens"
    assert params["frontend_proj"].shape == (cfg.d_model, cfg.d_model)
    np.testing.assert_array_equal(params["frontend_proj"].numpy(),
                                  np.asarray(jparams["frontend_proj"]))
    own = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert own["frontend_proj"].shape == (cfg.d_model, cfg.d_model)
    assert "frontend_proj" not in M.init_params(get_config("qwen2-7b").reduced(),
                                                torch.Generator().manual_seed(0), device="cpu")


def test_forward_from_embeds_matches_jax(bridged):
    jcfg, cfg, jparams, params = bridged
    emb = _embeds(cfg, (2, 19), seed=1)
    want, _ = JM.forward(jparams, jcfg, {"embeds": jnp.asarray(emb)})
    got, aux = M.forward(params, cfg, {"embeds": torch.from_numpy(emb)})
    assert got.shape == (2, 19, cfg.padded_vocab) and float(aux) == 0.0
    _close(got, want)


def test_prefill_from_embeds_then_decode_from_tokens_matches_jax(bridged):
    jcfg, cfg, jparams, params = bridged
    emb = _embeds(cfg, (2, 19), seed=2)
    want, jcache = JM.prefill(jparams, jcfg, {"embeds": jnp.asarray(emb)}, max_len=32)
    got, cache = M.prefill(params, cfg, {"embeds": torch.from_numpy(emb)}, max_len=32)
    _close(got, want)
    _close(cache["k"], jcache["k"])
    feed = np.random.default_rng(3).integers(0, cfg.vocab_size, size=(4, 2)).astype(np.int32)
    for tok in feed:
        want, jcache = JM.decode_step(jparams, jcfg, jcache, jnp.asarray(tok))
        got, cache = M.decode_step(params, cfg, cache, torch.from_numpy(tok).long())
        _close(got, want)
    _close(cache["v"], jcache["v"])
    np.testing.assert_array_equal(cache["lengths"].numpy(), np.asarray(jcache["lengths"]))


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "qwen3-moe-30b-a3b", "internvl2-76b",
                                  "musicgen-medium"])
def test_serve_cli_serves_the_arch_on_the_cpu(arch, capsys):
    serve.main(["--arch", arch, "--device", "cpu", "--episodes", "1"])
    assert "served 1 episodes, 24 decode steps" in capsys.readouterr().out
