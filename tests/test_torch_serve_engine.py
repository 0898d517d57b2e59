"""repro_torch.serve.engine, KNNDatastore.from_corpus and
repro_torch.launch.serve against repro's, on the CPU.

The smoke ``tinyllama-1.1b`` (float32) runs in both packages with the
reference's weights (``params_from_reference``), on the same numpy prompt
and corpus tokens.  Both kNN-LM stores come from ``from_corpus`` over the
same batches (the launcher's store: 4 batches of 4 x 32 tokens, 8 pivots,
blocks of 64, k = 8).  Greedy decoding gives the reference's tokens with
kNN off and on; every step's next-token distribution is held to the
reference's within ``PROBS_ATOL``, and a row's tokens are compared up to
the first step where the reference's two most likely tokens lie within
twice that of each other (no such step occurs with these seeds).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import smoke_config as j_smoke  # noqa: E402
from repro.models import model_fns as j_model_fns  # noqa: E402
from repro.serve.engine import Engine as JEngine  # noqa: E402
from repro.serve.knnlm import KNNDatastore as JDatastore  # noqa: E402
from repro_torch.configs import ARCHS, smoke_config  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models import MoEConfig, lm, model_fns, synthetic_batch  # noqa: E402
from repro_torch.serve.engine import Engine  # noqa: E402
from repro_torch.serve.knnlm import KNNDatastore  # noqa: E402

ARCH = "tinyllama-1.1b"
#: hidden states and keys: the same float32 products summed in another order
ATOL = 1e-5
#: next-token probabilities (softmax of logits within ATOL, kNN weights of
#: similarities within 1e-6 at temperature 10)
PROBS_ATOL = 1e-5
PROMPT, GEN, REQUESTS, LMBDA = 16, 8, 3, 0.25
STORE = dict(k=8, n_pivots=8, block_size=64)


@pytest.fixture(scope="module")
def models():
    """(reference fns, params; port fns, model) of the smoke config."""
    jcfg, cfg = j_smoke(ARCH), smoke_config(ARCH)
    jfns = j_model_fns(jcfg)
    jp = jfns.init(jax.random.PRNGKey(0))
    return jfns, jp, model_fns(cfg), lm.params_from_reference(
        jax.tree.map(np.asarray, jp), cfg, "cpu")


@pytest.fixture(scope="module")
def stores(models):
    """Both packages' from_corpus stores over the same numpy batches."""
    jfns, jp, fns, model = models
    rng = np.random.default_rng(11)
    corpus = [rng.integers(0, fns.cfg.vocab, (4, 32)).astype(np.int32) for _ in range(4)]
    jds = JDatastore.from_corpus(jfns, jp, [{"tokens": jnp.asarray(t)} for t in corpus],
                                 fns.cfg.vocab, **STORE)
    ds = KNNDatastore.from_corpus(fns, model, [{"tokens": t} for t in corpus],
                                  fns.cfg.vocab, device="cpu", **STORE)
    return jds, ds


def keys_by_id(index):
    """The stored keys in row-id order, and their ids."""
    valid = np.asarray(index.valid)
    ids, db = np.asarray(index.row_ids)[valid], np.asarray(index.db)[valid]
    out = np.zeros_like(db)
    out[ids] = db
    return out, np.sort(ids)


def test_from_corpus_matches_reference(stores):
    """The same (key, next token) pairs: keys within 1e-6 by row id, the
    value table exactly; the store holds 4 x 4 x 31 pairs."""
    jds, ds = stores
    jk, jids = keys_by_id(jds.index)
    k, ids = keys_by_id(ds.index)
    assert len(ids) == 4 * 4 * 31
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_allclose(k, jk, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(ds.values.numpy(), np.asarray(jds.values))
    assert ds.engine.backend_name == jds.engine.backend_name


def test_engine_prefill_then_decode_matches_forward(models):
    _, _, fns, model = models
    toks = np.random.default_rng(12).integers(0, fns.cfg.vocab, (2, 10)).astype(np.int32)
    eng = Engine(fns, model, max_seq=40)
    cache, clen, last_h = eng.prefill({"tokens": toks})
    h_full, _, _ = fns.forward(model, {"tokens": toks})
    np.testing.assert_allclose(last_h.numpy(), h_full[:, -1].numpy(), atol=ATOL)
    out, _ = eng.decode(cache, clen, toks[:, -1:], 5)
    assert out.shape == (2, 5) and out.dtype == torch.int32
    assert int(out.max()) < fns.cfg.vocab


#: one arch of each family the serving path gained after the "attn" LM; the
#: MoE's capacity factor lets every expert take every token, so its
#: cache-free forward (capacity dispatch) drops none and equals the cache
#: path (no_drop), as the reference's test requires of an "attn" LM
FAMILIES = {"granite-moe-1b-a400m": dict(moe=MoEConfig(n_experts=8, top_k=2,
                                                       capacity_factor=4.0)),
            "zamba2-1.2b": {}, "rwkv6-1.6b": {}, "internvl2-1b": {}, "whisper-small": {}}


@pytest.fixture
def one_thread():
    """Smoke-size torch ops on one thread: under the suite's parallel
    workers, torch's per-process pool of one thread per core makes these
    small ops wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", list(FAMILIES))
def test_engine_prefill_then_decode_matches_forward_by_family(one_thread, arch):
    """The reference's test_engine_prefill_then_decode_matches_forward and
    its decode checks (tests/test_serve.py), on the port alone: the
    prefill's last hidden state equals the forward's within 2e-4, the first
    decode step's logits the forward's over the prompt with its last token
    repeated within 2e-3, and two decodes from one prefilled cache give the
    same tokens."""
    cfg = smoke_config(arch).replace(**FAMILIES[arch])
    fns = model_fns(cfg)
    params = fns.init(0, device="cpu")
    batch = synthetic_batch(cfg, 2, 10, device="cpu")
    eng = Engine(fns, params, max_seq=fns.loss_offset(batch) + 40)
    cache, clen, last_h = eng.prefill(batch)
    assert clen == fns.loss_offset(batch) + 10
    with torch.inference_mode():
        h_full, _, _ = fns.forward(params, batch)
        np.testing.assert_allclose(last_h.numpy(), h_full[:, -1].numpy(), atol=2e-4)
        ext = dict(batch, tokens=torch.cat([batch["tokens"], batch["tokens"][:, -1:]], 1))
        h_ext, _, _ = fns.forward(params, ext)
        _, logits, _ = eng._decode_step(params, batch["tokens"][:, -1:], cache, clen)
    np.testing.assert_allclose(logits.numpy(), fns.lm_head(params, h_ext)[:, -1].numpy(),
                               atol=2e-3)
    t1, _ = eng.decode(cache, clen, batch["tokens"][:, -1:], 5)
    t2, _ = eng.decode(cache, clen, batch["tokens"][:, -1:], 5)
    assert t1.shape == (2, 5) and int(t1.max()) < cfg.vocab
    assert torch.equal(t1, t2)


@pytest.mark.parametrize("arch", sorted(a for a in ARCHS
                                         if set(ARCHS[a].layer_types) != {"attn"}
                                         or ARCHS[a].encoder_layers or ARCHS[a].vision_seq))
def test_launcher_runs_every_family_on_cpu(one_thread, capsys, arch):
    """The launcher at its defaults with kNN on, at the smoke config of
    each of the six archs of the MoE, Mamba2, RWKV6, vlm and whisper
    families (mixtral-8x22b's among them): 8 requests of 16 greedy tokens
    over a store of 4 x 4 x 31 keys (512 rows in blocks of 64)."""
    toks = launch_serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--knn"])
    assert toks.shape == (8, 16) and int(toks.max()) < smoke_config(arch).vocab
    out = capsys.readouterr().out
    assert "knn=on" in out and "on cpu" in out and "datastore: 512 keys" in out


@pytest.mark.parametrize("knn", [False, True], ids=["knn_off", "knn_on"])
def test_engine_greedy_decode_matches_reference(models, stores, knn):
    jfns, jp, fns, model = models
    jds, ds = stores if knn else (None, None)
    prompt = np.random.default_rng(13).integers(
        0, fns.cfg.vocab, (REQUESTS, PROMPT)).astype(np.int32)
    jeng = JEngine(jfns, jp, max_seq=PROMPT + GEN + 8, knn=jds, lmbda=LMBDA)
    eng = Engine(fns, model, max_seq=PROMPT + GEN + 8, knn=ds, lmbda=LMBDA)
    first = prompt[:, -1:]
    jc, jlen, jlast = jeng.prefill({"tokens": jnp.asarray(prompt)})
    c, clen, last = eng.prefill({"tokens": prompt})
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast), atol=ATOL)
    want = np.asarray(jeng.decode(jc, jlen, jnp.asarray(first), GEN)[0])
    got = eng.decode(c, clen, first, GEN)[0].numpy()

    # teacher-forced on the reference's tokens: each step's distribution
    jc, jlen, _ = jeng.prefill({"tokens": jnp.asarray(prompt)})
    c, clen, _ = eng.prefill({"tokens": prompt})
    aligned = np.ones(REQUESTS, bool)
    toks = first
    for i in range(GEN):
        jh, jlogits, jc = jeng._decode_jit(jp, jnp.asarray(toks), jc, jlen)
        jprobs = jax.nn.softmax(jlogits, axis=-1)
        if knn:
            jprobs = jds.interpolate(jh, jprobs, LMBDA)
        with torch.inference_mode():
            h, logits, c = eng._decode_step(model, torch.tensor(toks), c, clen + i)
            probs = torch.softmax(logits, dim=-1)
            if knn:
                probs = ds.interpolate(h, probs, LMBDA)
        jprobs = np.asarray(jprobs)
        np.testing.assert_allclose(probs.numpy(), jprobs, atol=PROBS_ATOL, rtol=0)
        top2 = np.sort(jprobs, axis=1)[:, -2:]
        aligned &= top2[:, 1] - top2[:, 0] > 2 * PROBS_ATOL
        np.testing.assert_array_equal(got[aligned, i], want[aligned, i])
        jlen = jlen + 1
        toks = want[:, i:i + 1]
    assert aligned.all(), "a near-tie: the comparison of tokens stopped early"


def test_engine_temperature_sampling_is_seeded(models):
    _, _, fns, model = models
    prompt = np.random.default_rng(14).integers(0, fns.cfg.vocab, (2, 8)).astype(np.int32)
    eng = Engine(fns, model, max_seq=24)
    runs = []
    for seed in (3, 3, 4):
        cache, clen, _ = eng.prefill({"tokens": prompt})
        runs.append(eng.decode(cache, clen, prompt[:, -1:], 10, temperature=0.8,
                               seed=seed)[0])
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])
    assert int(runs[0].max()) < fns.cfg.vocab


@pytest.mark.parametrize("knn", [False, True], ids=["knn_off", "knn_on"])
def test_launcher_runs_on_cpu(capsys, knn):
    argv = ["--smoke", "--device", "cpu", "--requests", "2", "--prompt-len", "12",
            "--gen", "4"] + (["--knn"] if knn else [])
    toks = launch_serve.main(argv)
    assert toks.shape == (2, 4) and int(toks.max()) < smoke_config(ARCH).vocab
    out = capsys.readouterr().out
    assert f"knn={'on' if knn else 'off'}" in out and "on cpu" in out
    assert ("datastore: 192 keys, backend=brute" in out) == knn


def test_launcher_defaults_match_reference(monkeypatch):
    """The reference's flags and defaults, plus --device (cuda)."""
    import argparse

    from repro.launch import serve as j_serve

    seen = []
    real = argparse.ArgumentParser.parse_args

    def capture(self, args=None, namespace=None):
        seen.append(vars(real(self, [], namespace)))
        raise SystemExit(0)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    for main in (launch_serve.main, j_serve.main):
        with pytest.raises(SystemExit):
            main([])
    mine, ref = seen
    assert mine.pop("device") == "cuda"
    assert mine == ref
