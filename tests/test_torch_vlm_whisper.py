"""repro_torch.models.vlm and repro_torch.models.whisper against repro's,
on the CPU.

The smoke internvl2-1b (8 vision positions ahead of the text, the
projector from the ViT width 1024) and the smoke whisper-small (2 encoder
layers over 24 frames, 4 decoder layers with cross-attention; layernorm,
GELU) run in float32 in both packages with the reference's weights
(``params_from_reference``), on the same numpy tokens, patches and frames.
Tolerances are the reference's own (tests/test_serve.py): 2e-4 on hidden
states, 2e-3 on logits.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.models import vlm as jvlm  # noqa: E402
from repro.models import whisper as jwh  # noqa: E402
from repro_torch.models import model_fns  # noqa: E402
from repro_torch.models import vlm, whisper  # noqa: E402
from tests.test_torch_models import (HIDDEN_ATOL, assert_forward_matches,  # noqa: E402
                                     assert_prefill_decode_matches, close, family_batch,
                                     ref_family)

ARCHS = ["internvl2-1b", "whisper-small"]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Smoke-size torch ops on one thread: under the suite's parallel
    workers, torch's per-process pool of one thread per core makes these
    small ops wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    """arch -> (reference cfg, fns, params; port cfg, model)."""
    return {arch: ref_family(arch) for arch in ARCHS}


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_hidden_matches_reference(models, arch):
    """vlm_forward over patches + tokens (Sv + St positions), or
    whisper_forward over frames and tokens."""
    jcfg, jfns, jp, cfg, model = models[arch]
    batch = family_batch(cfg, 2, 17)
    h = assert_forward_matches(jcfg, jfns, jp, cfg, model, batch)
    assert h.shape[1] == model_fns(cfg).loss_offset(batch) + 17


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_logits_match_reference(models, arch):
    """Engine.prefill (the vlm's vision prefix and prompt through the cache
    path together; whisper's encoder in cache_init, its decoder over the
    prompt), then 5 decode steps' logits."""
    jcfg, jfns, jp, cfg, model = models[arch]
    assert_prefill_decode_matches(jfns, jp, model_fns(cfg), model,
                                  family_batch(cfg, 2, 11, seed=2))


def test_project_patches_matches_reference(models):
    jcfg, _, jp, cfg, model = models["internvl2-1b"]
    p = family_batch(cfg, 3, 1, seed=3)["patches"]
    close(vlm.project_patches(model, p, cfg),
          jvlm.project_patches(jp, jnp.asarray(p), jcfg), HIDDEN_ATOL)


def test_whisper_encoder_and_cross_kv_match_reference(models):
    """encode over the frames (non-causal), and whisper_cache_init's
    per-layer cross K/V from it."""
    jcfg, _, jp, cfg, model = models["whisper-small"]
    f = family_batch(cfg, 2, 1, seed=4)["frames"]
    close(whisper.encode(model, f, cfg), jwh.encode(jp, jnp.asarray(f), jcfg), HIDDEN_ATOL)
    cache = whisper.whisper_cache_init(model, f, cfg, 2, 16)
    jcache = jwh.whisper_cache_init(jp, jnp.asarray(f), jcfg, 2, 16)
    for li, c in enumerate(cache):
        for n in ("cross_k", "cross_v"):
            close(c[n], np.asarray(jcache[n])[li], HIDDEN_ATOL)
        assert c["self"]["k"].shape == tuple(jcache["self"]["k"].shape[1:])
