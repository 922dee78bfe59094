"""Pipeline parallel of vlp3d_torch (``vlp3d_torch.parallel.pipeline``)
against the JAX package's sequential BERT text layers
(``vlp3d.models.bert.BertTextEncoder`` in text mode, the oracle of
tests/test_pipeline_parallel.py, at its sizes).

One launch of 4 gloo ranks (tests/torch_parallel_jobs.py's ``pipeline``
job) runs every case: (S, M) = (2, 2) and (2, 4), two pipes of 2 stages
side by side; 4 stages with 2 microbatches; dp 2 x pp 2, each data rank
running its rows of every microbatch. The output (replicated on every
stage) and the gradients of the mean square of the output (each stage's
layers, and the embeddings on stage 0, where the input gradient arrives;
the data group's average under dp) equal JAX's ``jax.grad`` of the
sequential layers within atol 5e-5 (float32 sums in another order; JAX's
own pipeline test holds 2e-5 on values and 5e-5 on gradients). The
shapes that JAX refuses raise with its messages.
"""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_distributed import run_ranks
from vlp3d.models.bert import BertConfig as JaxBertConfig
from vlp3d.models.bert import BertTextEncoder as JaxBertTextEncoder
from vlp3d_torch.convert import convert_text_encoder, to_tensors

CFG = dict(vocab_size=97, hidden_size=32, num_hidden_layers=4,
           num_attention_heads=4, intermediate_size=64,
           max_position_embeddings=40, fusion_layer=4)
B, SEQ = 8, 10
CASES = [dict(name="pp2_m2", pp=2, mb=2, dp=False),
         dict(name="pp2_m4", pp=2, mb=4, dp=False),
         dict(name="pp4_m2", pp=4, mb=2, dp=False),
         dict(name="dp2_pp2", pp=2, mb=2, dp=True)]
ATOL = 5e-5


@pytest.fixture(scope="module")
def jax_ref():
    """Seeded inputs, JAX's encoder state in the port's layout, its output
    and the gradients of the mean square of the output."""
    enc = JaxBertTextEncoder(JaxBertConfig(**CFG))
    rng = np.random.default_rng(7)
    ids = rng.integers(0, CFG["vocab_size"], (B, SEQ)).astype(np.int32)
    mask = (rng.integers(0, 2, (B, SEQ))
            | np.eye(1, SEQ, dtype=np.int64)[0]).astype(np.int32)
    params = enc.init(jax.random.PRNGKey(0), jnp.asarray(ids),
                      jnp.asarray(mask))["params"]

    def loss(p):
        out = enc.apply({"params": p}, jnp.asarray(ids), jnp.asarray(mask),
                        mode="text")
        return jnp.mean(out ** 2), out

    (_, out), grads = jax.value_and_grad(loss, has_aux=True)(params)

    def port(tree):
        sd = {}
        convert_text_encoder(jax.device_get(tree), "", sd)
        return to_tensors(sd)

    return dict(ids=ids, mask=mask, sd=port(params), out=np.asarray(out),
                grads=port(grads))


@pytest.fixture(scope="module")
def ranks(jax_ref, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pp")
    torch.save(jax_ref["sd"], tmp / "enc.pt")
    np.savez(tmp / "in.npz", ids=jax_ref["ids"],
             mask=jax_ref["mask"].astype(np.float32))
    res = run_ranks("pipeline", dict(cfg=CFG, state=str(tmp / "enc.pt"),
                                     npz=str(tmp / "in.npz"), cases=CASES),
                    tmp, world=4)
    shutil.rmtree(tmp, ignore_errors=True)
    return res


@pytest.mark.parametrize("case", [c["name"] for c in CASES])
def test_pipeline_matches_sequential_layers(jax_ref, ranks, case):
    seen = set()
    for r in ranks:
        np.testing.assert_allclose(r[f"{case}/out"], jax_ref["out"],
                                   atol=ATOL, rtol=0, err_msg=case)
        layers = {f"bert.encoder.layer.{i}." for i in r[f"{case}/layers"]}
        stage = int(r[f"{case}/stage"])
        grads = {k[len(case) + 6:]: v for k, v in r.items()
                 if k.startswith(f"{case}/grad.")}
        for name, g in grads.items():
            if name.startswith("bert.embeddings."):
                assert stage == 0, name
            else:
                assert any(name.startswith(p) for p in layers), name
            np.testing.assert_allclose(g, jax_ref["grads"][name].numpy(),
                                       atol=ATOL, rtol=0,
                                       err_msg=f"{case} {name}")
            seen.add(name)
    # every parameter of the encoder got its gradient on some stage
    assert seen == set(jax_ref["grads"]) - {"bert.embeddings.position_ids"}


def test_bad_shapes_raise(ranks):
    for r in ranks:
        errors = [str(e) for e in r["errors"]]
        assert "no 'pipe' group" in errors[0], errors
        assert "6 layers not divisible by 4 stages" in errors[1], errors
        assert "batch 8 not divisible by 3 microbatches" in errors[2], errors
        assert "data-axis size 4" in errors[3], errors
