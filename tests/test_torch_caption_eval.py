"""The port's Scan2Cap evaluation and captioning CLIs against the JAX
package's, on the CPU.

The numpy / pure-Python evaluation copies (``eval/detection.py``,
``capeval.py``, ``meteor.py``, ``captioning.py``) on the same inputs as
``vlp3d``'s: scores, masks, candidates and corpora equal, mAP within
1e-9. The CLIs: ``vlp3d.cli.caption_predict.main(["--synthetic",
"--smoke"])`` and ``vlp3d.cli.caption_eval.main`` run the JAX model from
its seeded train state; that state, rebuilt as the JAX CLIs build it,
goes through ``convert.jax_to_torch_state_dict`` into the port's
``save_params`` snapshot, and the port's CLIs run over the same synthetic
val split with ``--model_dir`` on the CPU. Every decoded caption row
(recorded where each package calls its greedy decode) must equal JAX's by
the tie rule (a row may differ only where JAX's top-2 logit margin at the
first differing step is below 1e-4); pred.json's boxes within 1e-4, its
probabilities within 1e-5, its captions equal where the rows are; the
caption metrics within 1e-6 where every row is equal. HashTokenizer ids
agree only within one process, so every CLI runs here. Last,
``train_caption --pretrain`` from a grounding snapshot: the caption head
is the fresh part.
"""

import argparse
import json
import shutil

import jax
import numpy as np
import pytest
import torch

import vlp3d.models.caption as jax_caption_mod
import vlp3d_torch.serving as port_serving
from vlp3d.cli.caption_eval import main as jax_caption_eval
from vlp3d.cli.caption_predict import main as jax_caption_predict
from vlp3d.cli.common import add_common_args, build_datasets, resolve_config
from vlp3d.data.dataset import BatchIterator
from vlp3d.data.tokenizer import BertWordPieceTokenizer as JaxWordPiece
from vlp3d.data.tokenizer import HashTokenizer as JaxHash
from vlp3d.eval import capeval as jax_capeval
from vlp3d.eval import captioning as jax_captioning
from vlp3d.eval import detection as jax_detection
from vlp3d.eval import meteor as jax_meteor
from vlp3d.models.jointnet import JointNet as JaxJointNet
from vlp3d.train.optimizer import make_optimizer
from vlp3d.train.state import create_state
from vlp3d_torch.cli.caption_eval import main as port_caption_eval
from vlp3d_torch.cli.caption_predict import main as port_caption_predict
from vlp3d_torch.cli.train_caption import main as port_train_caption
from vlp3d_torch.convert import jax_to_torch_state_dict
from vlp3d_torch.data.synthetic import tiny_config
from vlp3d_torch.data.tokenizer import BertWordPieceTokenizer, HashTokenizer
from vlp3d_torch.eval import capeval, captioning, detection, meteor
from vlp3d_torch.models import JointNet
from vlp3d_torch.train.checkpoint import save_params

ARGS = ["--synthetic", "--smoke", "--num_workers", "2"]
BOX_TOL, PROB_TOL, METRIC_TOL, TIE_MARGIN = 1e-4, 1e-5, 1e-6, 1e-4
WORDS = ["the", "chair", "table", "is", "a", "brown", "next", "to", "bed",
         "window", "door", "on", "left", "of", ".", ",", "it", "'s"]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------- evaluation copies


def _sentences(rng, n, framed=True):
    out = []
    for _ in range(n):
        words = " ".join(rng.choice(WORDS, rng.integers(2, 12)))
        out.append(f"[CLS] {words} [SEP]" if framed else words)
    return out


def _corpus(seed):
    rng = np.random.default_rng(seed)
    gts = {f"scene{i:04d}_00|{i}|chair": _sentences(rng, rng.integers(1, 4))
           for i in range(12)}
    res = {k: _sentences(rng, 1) for k in gts}
    res[next(iter(res))] = list(gts[next(iter(gts))][:1])  # an exact hit
    return gts, res


@pytest.mark.parametrize("scorer", ["Bleu", "Cider", "Rouge", "Meteor"])
@pytest.mark.parametrize("seed", [0, 1])
def test_caption_scorers_equal_jax(scorer, seed):
    gts, res = _corpus(seed)
    args = (4,) if scorer == "Bleu" else ()
    want = getattr(jax_capeval, scorer)(*args).compute_score(gts, res)
    got = getattr(capeval, scorer)(*args).compute_score(gts, res)
    assert got == want


def test_meteor_stemmer_and_normalisation_equal_jax():
    rng = np.random.default_rng(2)
    words = ["running", "generously", "chairs", "tables'", "happiness",
             "relational", "conditional", "fly", "dying", "skis"]
    words += ["".join(rng.choice(list("abcdeilnorstuy"), rng.integers(2, 12)))
              for _ in range(200)]
    assert [meteor.stem(w) for w in words] == [jax_meteor.stem(w)
                                               for w in words]
    text = "The chair, next to it's bed-side table. [SEP]"
    assert meteor.meteor_normalize(text) == jax_meteor.meteor_normalize(text)


def _det_outputs(seed, b=2, k=24, n=600):
    rng = np.random.default_rng(seed)
    return {
        "pred_center": rng.uniform(0, 3, (b, k, 3)).astype(np.float32),
        "pred_size": rng.uniform(0.3, 1.5, (b, k, 3)).astype(np.float32),
        "pred_heading": np.zeros((b, k), np.float32),
        "objectness_scores": rng.normal(0, 2, (b, k, 2)).astype(np.float32),
        "sem_cls_scores": rng.normal(0, 2, (b, k, 18)).astype(np.float32),
        "point_clouds": rng.uniform(0, 3, (b, n, 6)).astype(np.float32),
    }


POSTS = [{}, {"remove_empty_box": True, "use_3d_nms": True, "nms_iou": 0.25,
              "use_old_type_nms": False, "cls_nms": True,
              "per_class_proposal": True, "conf_thresh": 0.05},
         {"use_3d_nms": False}, {"cls_nms": False},
         {"per_class_proposal": False}, {"use_old_type_nms": True}]


@pytest.mark.parametrize("post", range(len(POSTS)))
def test_parse_predictions_equals_jax(post):
    out = _det_outputs(post)
    want_mask, want = jax_detection.parse_predictions(out, POSTS[post])
    got_mask, got = detection.parse_predictions(out, POSTS[post])
    np.testing.assert_array_equal(got_mask, want_mask)
    assert want_mask.sum() > 0
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for (gc, gb, gs), (wc, wb, ws) in zip(g, w):
            assert gc == wc and gs == ws
            np.testing.assert_array_equal(gb, wb)


def _gt_batch(seed, b=2, k=8):
    rng = np.random.default_rng(seed)
    return {
        "center_label": rng.uniform(0, 3, (b, k, 3)).astype(np.float32),
        "size_class_label": rng.integers(0, 18, (b, k)),
        "size_residual_label": rng.normal(0, 0.1, (b, k, 3)).astype(
            np.float32),
        "box_label_mask": (rng.uniform(size=(b, k)) < 0.7).astype(np.float32),
        "sem_cls_label": rng.integers(0, 18, (b, k)),
    }


@pytest.mark.parametrize("iou", [0.25, 0.5])
def test_ap_calculator_equals_jax(iou):
    mean_size = np.random.default_rng(3).uniform(0.4, 1.2, (18, 3)).astype(
        np.float32)
    ap, jap = detection.APCalculator(iou), jax_detection.APCalculator(iou)
    for seed in range(3):
        out = _det_outputs(10 + seed)
        gt = _gt_batch(20 + seed)
        # some predictions on the GT boxes, so the AP is not 0
        out["pred_center"][:, :4] = gt["center_label"][:, :4]
        _, preds = detection.parse_predictions(out, {})
        _, jpreds = jax_detection.parse_predictions(out, {})
        ap.step(preds, detection.parse_groundtruths(gt, mean_size))
        jap.step(jpreds, jax_detection.parse_groundtruths(gt, mean_size))
    got, want = ap.compute_metrics(), jap.compute_metrics()
    assert set(got) == set(want) and want["mAP"] > 0
    for k, w in want.items():
        assert abs(got[k] - w) <= 1e-9, k


def _anns():
    return [{"scene_id": f"scene{s:04d}_00", "object_id": str(o),
             "object_name": ["chair", "table"][o % 2], "ann_id": str(a),
             "token": WORDS[a:a + 8 + o]}
            for s in range(2) for o in range(3) for a in range(2)]


def test_corpus_and_decode_caption_equal_jax(tmp_path):
    anns = _anns()
    assert captioning.prepare_corpus(anns, 6) == \
        jax_captioning.prepare_corpus(anns, 6)
    assert captioning.organize_scanrefer(anns) == \
        jax_captioning.organize_scanrefer(anns)
    vocab = tmp_path / "vocab.txt"
    vocab.write_text("\n".join(["[PAD]"] + [f"[unused{i}]" for i in range(99)]
                               + ["[UNK]", "[CLS]", "[SEP]", "[MASK]"]
                               + WORDS + ["##s", "##ing", "n't"]) + "\n")
    rng = np.random.default_rng(4)
    rows = rng.integers(100, 100 + 4 + len(WORDS) + 3, (20, 12))
    rows[:, 0] = 101
    rows[::3, 6] = 102  # SEP inside some rows
    for port_tok, jax_tok in ((HashTokenizer(), JaxHash()),
                              (BertWordPieceTokenizer(str(vocab)),
                               JaxWordPiece(str(vocab)))):
        for row in rows:
            assert captioning.decode_caption(port_tok, row) == \
                jax_captioning.decode_caption(jax_tok, row)


def test_collect_and_score_captions_equal_jax():
    out = _det_outputs(30, b=2, k=16)
    gt = _gt_batch(31, b=2, k=8)
    rng = np.random.default_rng(32)
    assignment = rng.integers(0, 8, (2, 16))
    # proposals on their assigned boxes, so some pass the IoU gate
    centers = np.take_along_axis(gt["center_label"], assignment[..., None], 1)
    out["pred_center"][:, :8] = centers[:, :8]
    out["pred_size"][:, :8] = 1.0
    corners = np.stack([[jax_detection.get_3d_box(np.ones(3), 0.0, c)
                         for c in scene] for scene in gt["center_label"]])
    out["lang_cap_ids"] = rng.integers(100, 130, (2, 16, 10))
    batch = {"point_clouds": out["point_clouds"],
             "gt_box_corner_label": corners.astype(np.float32),
             "scene_object_ids": np.tile(np.arange(8), (2, 1)) % 3,
             "scene_id": ["scene0000_00", "scene0001_00"]}
    organized = captioning.organize_scanrefer(_anns())
    tok, jtok = HashTokenizer(), JaxHash()
    got = captioning.collect_caption_candidates(
        out, batch, tok, organized, object_assignment=assignment)
    want = jax_captioning.collect_caption_candidates(
        out, batch, jtok, organized, object_assignment=assignment)
    assert got == want and len(got) > 0
    corpus = captioning.prepare_corpus(_anns())
    assert captioning.score_captions(corpus, got) == \
        jax_captioning.score_captions(corpus, want)


# ------------------------------------------------------------------ the CLIs


def _jax_state():
    """The JAX caption CLIs' seeded state, built as
    vlp3d/cli/caption_predict.py builds it (:38-53)."""
    p = argparse.ArgumentParser()
    add_common_args(p)
    args = p.parse_args(ARGS)
    args.no_caption = False
    config = resolve_config(args)
    _, val_ds = build_datasets(args, config)
    sample = next(iter(BatchIterator(val_ds, config.train.batch_size,
                                     drop_last=False)))
    sample = {k: v for k, v in sample.items() if not isinstance(v, list)}
    state = create_state(JaxJointNet(config), make_optimizer(), sample,
                         config.train.seed)
    return config, jax.device_get(state)


class _Recorder:
    """Wraps a greedy decode, keeping each call's object tokens and ids."""

    def __init__(self, fn, port):
        self.fn, self.port, self.calls = fn, port, []

    def __call__(self, decoder, *args, **kw):
        ys = self.fn(decoder, *args, **kw)
        # JAX's takes (decoder, variables, obj_token, ...), the port's
        # (decoder, obj_token, ...)
        obj = None if self.port else np.asarray(args[1])
        self.calls.append((obj, np.asarray(ys)))
        return ys


def _run(jax_main, port_main, jax_argv, port_argv):
    """Both CLIs, each with its greedy decode recorded: (JAX result, port
    result, JAX calls, port calls)."""
    jrec = _Recorder(jax_caption_mod.greedy_decode, port=False)
    prec = _Recorder(port_serving.greedy_decode, port=True)
    with pytest.MonkeyPatch.context() as m:
        m.setattr(jax_caption_mod, "greedy_decode", jrec)
        want = jax_main(ARGS + jax_argv)
    with pytest.MonkeyPatch.context() as m:
        m.setattr(port_serving, "greedy_decode", prec)
        got = port_main(ARGS + port_argv)
    return want, got, jrec.calls, prec.calls


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("caption_cli")
    config, state = _jax_state()
    model_dir = str(tmp / "run")
    save_params(model_dir, "model",
                jax_to_torch_state_dict(state.params, state.batch_stats))
    port_args = ["--model_dir", model_dir, "--device", "cpu"]
    jp, pp = str(tmp / "jax.json"), str(tmp / "port.json")
    predict = _run(jax_caption_predict, port_caption_predict,
                   ["--out", jp], port_args + ["--out", pp])
    evaluate = _run(jax_caption_eval, port_caption_eval, [], port_args)
    decoder = jax_caption_mod.CaptionDecoder(
        vocab_size=config.model.vocab_size,
        max_len=config.model.max_des_len + 2)
    return {"predict": predict, "eval": evaluate, "decoder": decoder,
            "variables": {"params": state.params["caption"]},
            "files": (jp, pp), "model_dir": model_dir}


def _tie_rule(runs, jax_calls, port_calls) -> int:
    """Every port row equals JAX's or is excused; returns the excused
    count."""
    dec, variables = runs["decoder"], runs["variables"]
    assert len(port_calls) == len(jax_calls) > 0
    excused = 0
    for (obj, want), (_, got) in zip(jax_calls, port_calls):
        assert got.shape == want.shape
        for r in np.flatnonzero((got != want).any(axis=1)):
            s = int(np.flatnonzero(got[r] != want[r])[0])
            logits = np.asarray(dec.apply(
                variables, obj[r:r + 1], want[r:r + 1], s - 1,
                method=jax_caption_mod.CaptionDecoder.decode_step)[0])
            top2 = np.sort(logits)[-2:]
            assert top2[1] - top2[0] < TIE_MARGIN, (r, s)
            excused += 1
    print(f"tie rule: {excused} rows excused")
    return excused


def test_caption_predict_equals_the_jax_cli(cli_runs):
    want, got, jcalls, pcalls = cli_runs["predict"]
    excused = _tie_rule(cli_runs, jcalls, pcalls)
    jp, pp = cli_runs["files"]
    assert json.load(open(jp)) == want and json.load(open(pp)) == got
    assert set(got) == set(want) and len(want) > 0
    n, differ = 0, 0
    for scene, recs in want.items():
        assert len(got[scene]) == len(recs)
        for g, w in zip(got[scene], recs):
            assert set(g) == {"caption", "box", "sem_prob", "obj_prob"}
            assert isinstance(g["caption"], str)
            assert g["caption"].startswith("[CLS]")
            assert g["caption"].endswith("[SEP]")
            differ += g["caption"] != w["caption"]
            box = np.asarray(g["box"])
            assert box.shape == (8, 3)
            assert np.abs(box - np.asarray(w["box"])).max() <= BOX_TOL
            for k in ("sem_prob", "obj_prob"):
                np.testing.assert_allclose(g[k], w[k], atol=PROB_TOL, rtol=0)
            n += 1
    assert n > 0 and differ <= excused


def test_caption_eval_equals_the_jax_cli(cli_runs):
    want, got, jcalls, pcalls = cli_runs["eval"]
    excused = _tie_rule(cli_runs, jcalls, pcalls)
    assert set(got) == set(want) == {"bleu-1", "bleu-2", "bleu-3", "bleu-4",
                                     "cider", "rouge", "meteor"}
    assert all(np.isfinite(v) for v in got.values())
    if excused == 0:
        for k, w in want.items():
            assert abs(got[k] - w) <= METRIC_TOL, k


def test_caption_eval_beam_search_runs(cli_runs, tmp_path):
    out = tmp_path / "metrics.json"
    got = port_caption_eval(ARGS + ["--model_dir", cli_runs["model_dir"],
                                    "--device", "cpu", "--num_beams", "3",
                                    "--length_penalty", "0.8",
                                    "--out", str(out)])
    assert json.load(open(out)) == got
    assert all(np.isfinite(v) for v in got.values())


def test_caption_clis_run_on_the_card_unless_asked(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (port_caption_predict, port_caption_eval):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main(ARGS + ["--out", str(tmp_path / "x.json")])


def test_train_caption_warm_starts_from_a_grounding_snapshot(tmp_path,
                                                             capsys):
    """run.sh's grounding stage, then train_caption --pretrain: every
    grounding entry is restored, the caption head's are the fresh ones,
    and the run trains the caption loss (--no_caption is dropped)."""
    ground = JointNet(tiny_config(no_caption=True, use_con=True),
                      device="cpu")
    path = save_params(str(tmp_path), "stage1", ground.state_dict())
    workdir = tmp_path / "caption"
    try:
        port_train_caption(
            ["--synthetic", "--smoke", "--no_caption", "--use_con",
             "--coslr", "--device", "cpu", "--num_workers", "1",
             "--num_scenes", "2", "--verbose", "1", "--workdir",
             str(workdir), "--pretrain", path])
        out = capsys.readouterr().out
        caption_model = JointNet(tiny_config(no_caption=False, use_con=True),
                                 device="cpu")
        fresh = sum(k.startswith("caption.")
                    for k in caption_model.state_dict())
        assert fresh > 0
        assert (f"warm-started from {path}: {len(ground.state_dict())} "
                f"entries restored, {fresh} fresh") in out
        with open(workdir / "log.jsonl") as f:
            train = [r for r in map(json.loads, f) if r["phase"] == "train"]
        assert train and all(np.isfinite(r["cap_loss"]) and r["cap_loss"] > 0
                             for r in train)
        info = json.load(open(workdir / "info.json"))
        assert info["args"]["no_caption"] is False
    finally:
        shutil.rmtree(tmp_path, ignore_errors=True)
