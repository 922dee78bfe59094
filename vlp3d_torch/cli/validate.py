"""The asset-gated validation runbook.

The port's counterpart of ``vlp3d/cli/validate.py``: point it at
whatever real assets exist and it runs every check they allow, then
writes a machine-readable report:

  tokenizer_golden     the port's WordPiece against HF's BertTokenizer
                       on the same vocab.txt (equal token ids); skipped,
                       with "no HF oracle", where ``transformers`` is
                       not installed
  bert_weight_import   a HF BERT checkpoint (``model.safetensors``, read
                       without the ``safetensors`` package, else
                       ``pytorch_model.bin``) into the text encoder,
                       shapes checked; a finite fixed-sentence forward;
                       the keys the encoder did not take
  scene_cache          a preprocess npy loads and passes the
                       stale-layout check
  predict_contract     one scene's grounding predictions as the
                       benchmark's pred.json records (train_3dvlp.py
                       predict(), :423-538)
  grounding_acc        Acc@0.25 / 0.5 of those predictions against the
                       GT boxes (about 0 with seeded weights)
  caption_smoke        greedy captions -> strings -> BLEU-4 / CIDEr /
                       ROUGE-L / METEOR against the scene's descriptions
                       (finite metrics)
  vqa_smoke            one scene's ScanQA questions through the answer
                       head -> EM@1 / EM@10 (train_qa.py's contract)
  multiview_hdf5       a 6-column cache + enet_feats_maxpool.hdf5
                       assemble bit for bit into the baked [xyz, normal,
                       multiview] cloud and flow through a dataset item
  torch_import_chain   a reference-layout .pth -> ``python -m
                       vlp3d_torch.cli.import_torch`` -> a snapshot ->
                       predict on the imported weights (the --pretrain
                       handoff, train_3dvlp.py:115-121)

Each check reports ok / fail / skipped (with its reason). The exit code
is 1 if and only if a check that was not skipped failed.

    python -m vlp3d_torch.cli.validate --bert_dir bert-base-uncased \\
        --scannet_data data/scannet_data --scanrefer_dir data/scanrefer
    python -m vlp3d_torch.cli.validate --synthetic_standins DIR \\
        [--model_dir RUN] [--device cpu]

The models run on ``--device`` (default: the current CUDA device).
``--model_dir``'s snapshot is loaded as far as it goes
(:func:`~vlp3d_torch.train.checkpoint.load_params_into`): every entry the
check's model has is taken, and the model's other entries (a head the
snapshot lacks) keep their seeded values; the counts are in the report.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import traceback

import numpy as np
import torch

SENTENCES = [
    "this is the brown wooden chair next to the round table .",
    "THE refrigerator, standing 2nd from the left; it's white.",
    "a gray couch against the wall with an unusualword on it",
]
# the probe entry torch_import_chain perturbs (JAX's match/Dense_0/kernel)
PROBE = "match.match.0.weight"


def _check(ok: bool, what: str) -> None:
    """A check's condition, kept under ``python -O`` (unlike assert)."""
    if not ok:
        raise ValueError(what)


def _tokenizer(args):
    from vlp3d_torch.data.tokenizer import load_tokenizer

    return load_tokenizer(os.path.join(args.bert_dir, "vocab.txt")
                          if args.bert_dir else None)


def check_tokenizer_golden(args) -> dict:
    vocab = os.path.join(args.bert_dir, "vocab.txt")
    if not args.bert_dir or not os.path.exists(vocab):
        return {"status": "skipped", "reason": "no --bert_dir/vocab.txt"}
    from vlp3d_torch.data.tokenizer import BertWordPieceTokenizer

    ours = BertWordPieceTokenizer(vocab)
    try:
        from transformers import BertTokenizer

        hf = BertTokenizer(vocab, do_lower_case=True)
    except Exception as exc:  # transformers missing
        enc = ours(SENTENCES, max_length=50)
        _check(int(enc["attention_mask"].sum()) > len(SENTENCES) * 2,
               "the WordPiece round trip kept too few tokens")
        return {"status": "skipped",
                "reason": f"no HF oracle ({exc!r}); round-trip sanity "
                          "only — golden comparison did not run"}
    mismatches = []
    for s in SENTENCES:
        want = hf(s, padding="max_length", truncation=True,
                  max_length=50)["input_ids"]
        got = ours([s], max_length=50)["input_ids"][0].tolist()
        if got != list(want):
            mismatches.append({"sentence": s, "ours": got, "hf": want})
    if mismatches:
        return {"status": "fail", "mismatches": mismatches}
    return {"status": "ok", "sentences": len(SENTENCES)}


def check_bert_weight_import(args) -> dict:
    if not args.bert_dir:
        return {"status": "skipped", "reason": "no --bert_dir"}
    if not any(os.path.exists(os.path.join(args.bert_dir, f))
               for f in ("pytorch_model.bin", "model.safetensors")):
        return {"status": "skipped",
                "reason": "no pytorch_model.bin/model.safetensors"}
    from vlp3d_torch.models.bert import (
        BertTextEncoder,
        bert_config_from_state_dict,
        load_hf_bert,
        read_hf_state_dict,
    )

    sd = read_hf_state_dict(args.bert_dir)
    cfg = bert_config_from_state_dict(sd)
    enc = BertTextEncoder(cfg, device=args.device).eval()
    unused = load_hf_bert(enc, sd)
    ids = np.zeros((1, 12), np.int64)
    ids[0, :6] = [t % cfg.vocab_size for t in (101, 2023, 2003, 1037, 3242,
                                               102)]
    ids = torch.from_numpy(ids).to(args.device)
    with torch.no_grad():
        cls = enc(ids, (ids != 0).long())[0, 0].cpu().numpy()
    return {
        "status": "ok" if np.isfinite(cls).all() else "fail",
        "config": {
            "hidden": cfg.hidden_size, "layers": cfg.num_hidden_layers,
            "vocab": cfg.vocab_size, "fusion_layer": cfg.fusion_layer,
        },
        "cls_norm": float(np.linalg.norm(cls)),
        "unconsumed_keys": unused[:20],
    }


def _scene_id(args, root: str | None = None) -> str | None:
    """--scene_id, else the first scene with a preprocess cache under
    ``root`` (default: --scannet_data)."""
    if args.scene_id:
        return args.scene_id
    root = root if root is not None else args.scannet_data
    if not os.path.isdir(root):
        return None
    suffix = f"_preprocess_{args.split}.npy"
    for f in sorted(os.listdir(root)):
        if f.endswith(suffix):
            return f[: -len(suffix)]
    return None


def check_scene_cache(args) -> dict:
    scene = _scene_id(args)
    if scene is None:
        return {"status": "skipped", "reason": "no --scannet_data scenes"}
    from vlp3d_torch.data.dataset import DirectorySceneSource

    data = DirectorySceneSource(args.scannet_data)(scene, args.split)
    pc = data["point_cloud"]  # the source raises on a stale layout
    return {
        "status": "ok", "scene_id": scene,
        "points": int(pc.shape[0]), "channels": int(pc.shape[1]),
        "boxes": int(data["instance_bboxes"].shape[0]),
    }


def _model(args, config):
    """The check's JointNet on --device, with --model_dir's snapshot
    loaded as far as it goes -> (model, the load's counts)."""
    from vlp3d_torch.models.jointnet import JointNet
    from vlp3d_torch.train.checkpoint import load_params_into

    model = JointNet(config, device=args.device)
    model.requires_grad_(False)
    weights = {"restored": 0, "fresh": len(model.state_dict()), "ignored": 0}
    if args.model_dir:
        weights = load_params_into(model, args.model_dir, "model")
    return model, weights


@torch.no_grad()
def _forward(model, batch: dict) -> dict:
    from vlp3d_torch.serving import to_device

    device = next(model.parameters()).device
    return model(to_device(batch, device), is_eval=True)


def _host(out: dict, keys) -> dict:
    return {k: out[k].cpu().numpy() for k in keys if k in out}


def _build_predict_env(args) -> dict:
    """One scene's dataset and model (shared by the predict, grounding,
    caption and import-chain checks)."""
    from vlp3d_torch.cli.common import load_scanrefer
    from vlp3d_torch.config import Config, DatasetConfig, ModelConfig
    from vlp3d_torch.data.dataset import (
        DirectorySceneSource,
        ScanReferJointDataset,
        build_nyu40id2class,
        load_raw2label,
    )

    scene = _scene_id(args)
    anns = [d for d in load_scanrefer(args.scanrefer_dir, args.split)
            if d["scene_id"] == scene][: args.max_annotations]
    if not anns:
        raise ValueError(f"no ScanRefer annotations for scene {scene}")
    source = DirectorySceneSource(args.scannet_data)
    # the input channels come from the cache, so stand-in assets work
    pc = source(scene, args.split)["point_cloud"]
    config = Config(
        dataset=DatasetConfig(num_points=args.num_points,
                              mean_size_path=args.mean_size_npz),
        model=ModelConfig(
            input_feature_dim=pc.shape[1] - 3 + 1,  # + height
            num_proposal=args.num_proposals,
            no_caption=args.no_caption,
            use_con=False,
            lang_num_max=1,
        ),
    )
    ds = ScanReferJointDataset(
        anns, source, _tokenizer(args), split=args.split,
        num_points=config.dataset.num_points, lang_num_max=1,
        use_height=True, mean_size_arr=config.dataset.mean_size_arr(),
        raw2label=load_raw2label(args.labels_tsv) if args.labels_tsv else {},
        nyu40id2class=(build_nyu40id2class(args.labels_tsv)
                       if args.labels_tsv else {}),
        bert_max_len=config.model.bert_seq_len, seed=0,
    )
    model, weights = _model(args, config)
    return {"ds": ds, "model": model, "config": config, "anns": anns,
            "weights": weights}


def _batches(ds, size: int):
    from vlp3d_torch.data.dataset import BatchIterator

    return BatchIterator(ds, size, drop_last=False)


def _chosen(out: dict) -> np.ndarray:
    """(B,) the objectness-masked argmax of each row's one sentence."""
    b, k = out["pred_center"].shape[:2]
    masks = np.argmax(out["objectness_scores"], -1) == 1
    conf = out["cluster_ref"].reshape(b, 1, k)
    return np.argmax(conf * masks[:, None, :], -1)[:, 0]


KEYS = ("cluster_ref", "objectness_scores", "pred_center", "pred_size")


def check_predict_contract(args, env) -> dict:
    from vlp3d_torch.eval.box_iou import get_3d_box

    records = []
    for batch in _batches(env["ds"], 4):
        out = _host(_forward(env["model"], batch), KEYS)
        pred = _chosen(out)
        for i in range(len(batch["scene_id"])):
            j = int(pred[i])
            bbox = get_3d_box(out["pred_size"][i, j], 0.0,
                              out["pred_center"][i, j])
            records.append({
                "scene_id": str(batch["scene_id"][i]),
                "object_id": int(batch["object_id_list"][i, 0]),
                "ann_id": int(batch["ann_id_list"][i, 0]),
                "bbox": np.asarray(bbox).tolist(),
                "unique_multiple": int(batch["unique_multiple_list"][i, 0]),
                "others": int(batch["others_list"][i, 0])
                if "others_list" in batch else 0,
            })
    for r in records:
        _check(np.asarray(r["bbox"]).shape == (8, 3), f"bad record {r}")
    # named after the report, so runs with other reports do not collide
    out_path = os.path.splitext(os.path.abspath(args.out))[0] + "_pred.json"
    with open(out_path, "w") as f:
        json.dump(records, f)
    return {"status": "ok", "records": len(records), "pred_json": out_path,
            "weights": env["weights"]}


def check_grounding_acc(args, env) -> dict:
    from vlp3d_torch.eval.box_iou import box3d_iou, get_3d_box

    mean_size = env["config"].dataset.mean_size_arr()
    ious = []
    for batch in _batches(env["ds"], 4):
        out = _host(_forward(env["model"], batch), KEYS)
        pred = _chosen(out)
        gt_center = batch["ref_center_label_list"][:, 0]
        gt_size = (mean_size[batch["ref_size_class_label_list"][:, 0]]
                   + batch["ref_size_residual_label_list"][:, 0])
        for i in range(len(batch["scene_id"])):
            j = int(pred[i])
            pb = get_3d_box(out["pred_size"][i, j], 0.0,
                            out["pred_center"][i, j])
            gb = get_3d_box(gt_size[i], 0.0, gt_center[i])
            ious.append(float(box3d_iou(np.asarray(pb), np.asarray(gb))))
    ious = np.asarray(ious)
    return {
        "status": "ok",
        "n": int(ious.size),
        "acc_at_025": float((ious >= 0.25).mean()),
        "acc_at_05": float((ious >= 0.5).mean()),
        "mean_iou": float(ious.mean()),
        "note": "random weights unless --model_dir given",
    }


def check_caption_smoke(args, env) -> dict:
    if args.no_caption:
        return {"status": "skipped", "reason": "--no_caption"}
    from vlp3d_torch.eval.capeval import Bleu, Cider, Meteor, Rouge
    from vlp3d_torch.models.caption import greedy_decode

    model, config = env["model"], env["config"]
    batch = next(iter(_batches(env["ds"], 2)))
    feats = _forward(model, batch)["aggregated_vote_features"]
    # one caption a scene chunk, from the first proposal's feature (a
    # smoke: the NMS + IoU-matched pipeline is caption_predict /
    # caption_eval)
    with torch.no_grad():
        toks = greedy_decode(model.caption.model, feats[:, :1, :],
                             config.model.max_des_len).cpu().numpy()
    tok = _tokenizer(args)
    gts, res = {}, {}
    for i, ann in enumerate(env["anns"][: toks.shape[0]]):
        key = f"{ann['scene_id']}|{ann['object_id']}"
        desc = ann.get("description") or " ".join(ann.get("token", []))
        gts.setdefault(key, []).append(" ".join(str(desc).lower().split()))
        if key not in res:
            res[key] = [tok.decode(toks[i])]
    metrics = {}
    for name, scorer in (("bleu4", Bleu(4)), ("cider", Cider()),
                         ("rouge", Rouge()), ("meteor", Meteor())):
        score, _ = scorer.compute_score(gts, res)
        if isinstance(score, (list, tuple)):
            score = score[-1]
        metrics[name] = float(score)
    finite = all(np.isfinite(v) for v in metrics.values())
    return {"status": "ok" if finite else "fail", "metrics": metrics,
            "note": "random weights unless --model_dir given"}


def check_vqa_smoke(args) -> dict:
    """One scene's ScanQA questions through JointNet(use_answer=True) ->
    EM@1 / EM@10 (train_qa.py's contract)."""
    qa_path = os.path.join(args.scanqa_dir, f"ScanQA_v1.0_{args.split}.json")
    if not args.scanqa_dir or not os.path.exists(qa_path):
        return {"status": "skipped",
                "reason": f"no --scanqa_dir/ScanQA_v1.0_{args.split}.json"}
    scene = _scene_id(args)
    if scene is None:
        return {"status": "skipped", "reason": "no --scannet_data scenes"}
    from vlp3d_torch.config import Config, DatasetConfig, ModelConfig
    from vlp3d_torch.data.dataset import DirectorySceneSource
    from vlp3d_torch.data.vqa_dataset import ScanQADataset, build_answer_vocab
    from vlp3d_torch.eval.vqa import answer_hits

    with open(qa_path) as f:
        qa = [q for q in json.load(f) if q["scene_id"] == scene]
    qa = qa[: args.max_annotations]
    if not qa:
        return {"status": "skipped",
                "reason": f"no ScanQA questions for scene {scene}"}
    vocab, _ = build_answer_vocab(qa)
    source = DirectorySceneSource(args.scannet_data)
    pc = source(scene, args.split)["point_cloud"]
    config = Config(
        dataset=DatasetConfig(num_points=args.num_points,
                              mean_size_path=args.mean_size_npz),
        model=ModelConfig(
            input_feature_dim=pc.shape[1] - 3 + 1,
            num_proposal=args.num_proposals, no_caption=True,
            use_con=False, use_answer=True, lang_num_max=1,
            num_answers=max(len(vocab), 1),
        ),
    )
    ds = ScanQADataset(
        qa, source, _tokenizer(args), answer_vocab=vocab,
        num_answers=max(len(vocab), 1), split=args.split,
        num_points=config.dataset.num_points, lang_num_max=1,
        use_height=True, mean_size_arr=config.dataset.mean_size_arr(),
        bert_max_len=config.model.bert_seq_len, seed=0,
    )
    model, weights = _model(args, config)
    batch = next(iter(_batches(ds, min(4, len(ds)))))
    scores = _forward(model, batch)["answer_scores"].cpu()
    cats = torch.as_tensor(np.asarray(batch["answer_cats"])).reshape(
        scores.shape[0], -1)
    k = min(10, scores.shape[-1])
    hit1, hitk = answer_hits(scores, cats, topk=k)
    acc1, acck = float(hit1.float().mean()), float(hitk.float().mean())
    ok = np.isfinite(acc1) and np.isfinite(acck)
    return {"status": "ok" if ok else "fail",
            "questions": len(qa), "answers": len(vocab),
            "em_at_1": acc1, f"em_at_{k}": acck, "weights": weights,
            "note": "random weights unless --model_dir given"}


def check_multiview_hdf5(args) -> dict:
    """The enet_feats_maxpool.hdf5 input modality (lib/configs/config.py:
    45): a 6-column (xyz, normal) cache + the hdf5 features assemble into
    the [xyz, normal, multiview] cloud a baked cache carries, and flow
    through a dataset item."""
    from vlp3d_torch.cli.common import load_scanrefer
    from vlp3d_torch.data.dataset import (
        DirectorySceneSource,
        ScanReferJointDataset,
    )

    root = args.multiview_nomv_data
    hdf5 = os.path.join(root, "enet_feats_maxpool.hdf5")
    if not os.path.isfile(hdf5):
        return {"status": "skipped",
                "reason": "needs --multiview_nomv_data with "
                          "enet_feats_maxpool.hdf5"}
    # the scene comes from the nomv cache itself: this check is gated on
    # its own assets alone
    scene = _scene_id(args, root=root)
    if scene is None:
        return {"status": "skipped",
                "reason": f"no *_preprocess_{args.split}.npy under {root}"}
    source = DirectorySceneSource(root, multiview_hdf5=hdf5)
    assembled = source(scene, args.split)["point_cloud"]
    n_mv = 128
    _check(assembled.shape[1] >= 3 + n_mv,
           f"assembled cloud {assembled.shape}")
    result = {"status": "ok", "columns": int(assembled.shape[1])}
    if args.scannet_data:
        baked = DirectorySceneSource(args.scannet_data)(
            scene, args.split)["point_cloud"]
        if baked.shape == assembled.shape:
            np.testing.assert_array_equal(assembled, baked)
            result["bit_identical_to_baked"] = True
    # the appended features survive the dataset's sampling and height
    # (needs ScanRefer annotations; without them the assembly above
    # already checked the modality)
    try:
        anns = [d for d in load_scanrefer(args.scanrefer_dir, args.split)
                if d["scene_id"] == scene][:2]
    except Exception:
        anns = []
    if not anns:
        result["item_check"] = "skipped (no ScanRefer annotations)"
        return result
    ds = ScanReferJointDataset(
        anns, source, _tokenizer(args), split=args.split,
        num_points=min(args.num_points, 512), lang_num_max=1,
        use_height=True, mean_size_arr=None, raw2label={}, nyu40id2class={},
        seed=0,
    )
    pc = ds[0]["point_clouds"]
    # xyz + normal(3) + multiview(128) + height(1)
    _check(pc.shape[1] == 3 + 3 + n_mv + 1, f"item cloud {pc.shape}")
    _check(bool(np.isfinite(pc).all()), "item cloud not finite")
    # the multiview block is live data, not zero padding
    _check(float(np.abs(pc[:, 6:6 + n_mv]).max()) > 0,
           "the multiview block is all zeros")
    result["item_channels"] = int(pc.shape[1])
    return result


def check_torch_import_chain(args, env) -> dict:
    """The --pretrain handoff end to end (train_3dvlp.py:115-121): a
    reference-layout .pth on disk -> the import CLI in a process of its
    own -> a snapshot -> predict. One entry is perturbed first, so that
    the chain's identity shows at the end."""
    from vlp3d_torch.cli.export_torch import reference_state_dict
    from vlp3d_torch.train.checkpoint import load_params

    model, config = env["model"], env["config"]
    sd = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    sd[PROBE] = sd[PROBE] * 1.01 + 0.001
    # the chain's files live with the stand-ins, else in a private
    # temporary directory: never the caller's cwd or a real asset dir
    if args.synthetic_standins:
        tdir = os.path.join(args.synthetic_standins, "standin_torch_ckpt")
    else:
        import tempfile

        tdir = tempfile.mkdtemp(prefix="vlp3d_torch_validate_chain_")
    os.makedirs(tdir, exist_ok=True)
    pth = os.path.join(tdir, "model_last.pth")
    torch.save(reference_state_dict(sd), pth)

    out_dir = os.path.join(tdir, "imported")
    argv = [sys.executable, "-m", "vlp3d_torch.cli.import_torch",
            "--checkpoint", pth, "--out", out_dir,
            "--fusion_layer", str(config.model.fusion_layer)]
    if args.device:
        argv += ["--device", args.device]
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env_vars = dict(os.environ)
    env_vars["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in env_vars.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    proc = subprocess.run(argv, capture_output=True, text=True, timeout=600,
                          env=env_vars)
    _check(proc.returncode == 0, proc.stderr[-1500:])

    imported = load_params(out_dir, "model")
    _check(torch.equal(imported[PROBE], sd[PROBE]), f"{PROBE} differs")
    model.load_state_dict(imported, strict=True)
    batch = next(iter(_batches(env["ds"], min(2, len(env["ds"])))))
    conf = _forward(model, batch)["cluster_ref"].cpu().numpy()
    _check(bool(np.isfinite(conf).all()), "cluster_ref not finite")
    return {"status": "ok", "probe_leaf": PROBE, "pth": pth,
            "imported_dir": out_dir, "pred_finite": True,
            "import_stdout": proc.stdout.strip().splitlines()[-1:]}


def main(argv=None):
    p = argparse.ArgumentParser(
        description="asset-gated validation runbook (see the module doc)")
    p.add_argument("--bert_dir", default="",
                   help="HF bert-base-uncased dir (vocab.txt + "
                        "pytorch_model.bin | model.safetensors)")
    p.add_argument("--scannet_data", default="",
                   help="preprocessed scenes ({scene}_preprocess_*.npy)")
    p.add_argument("--scanrefer_dir", default="",
                   help="dir with ScanRefer_filtered_{split}.json")
    p.add_argument("--scanqa_dir", default="",
                   help="dir with ScanQA_v1.0_{split}.json")
    p.add_argument("--labels_tsv", default="")
    p.add_argument("--mean_size_npz", default="")
    p.add_argument("--multiview_nomv_data", default="",
                   help="scene cache WITHOUT baked multiview plus "
                        "enet_feats_maxpool.hdf5 (the task-variant "
                        "datasets' input modality)")
    p.add_argument("--model_dir", default="",
                   help="a save_params snapshot directory (optional)")
    p.add_argument("--scene_id", default="")
    p.add_argument("--split", default="val")
    p.add_argument("--num_points", type=int, default=40000)
    p.add_argument("--num_proposals", type=int, default=256)
    p.add_argument("--max_annotations", type=int, default=8)
    p.add_argument("--no_caption", action="store_true")
    p.add_argument("--out", default="validate_report.json")
    p.add_argument("--synthetic_standins", default="",
                   help="write stand-in assets (the real assets' layouts, "
                        "vlp3d_torch.data.standins) into this dir and run "
                        "every check on them; explicit asset flags win")
    p.add_argument("--device", type=str, default=None,
                   help="torch device of the models (default: the current "
                        "CUDA device); cpu for the plain PyTorch ops")
    args = p.parse_args(argv)
    from vlp3d_torch.device import resolve_device

    args.device = str(resolve_device(args.device))  # raises without one

    if args.synthetic_standins:
        from vlp3d_torch.data.standins import write_standin_assets

        for flag, path in write_standin_assets(
                args.synthetic_standins).items():
            if not getattr(args, flag):
                setattr(args, flag, path)

    checks = {}

    def run(name, fn, *a):
        try:
            checks[name] = fn(*a)
        except Exception as exc:  # noqa: BLE001 - report, don't die
            checks[name] = {
                "status": "fail", "error": repr(exc),
                "traceback": traceback.format_exc()[-1500:],
            }

    run("tokenizer_golden", check_tokenizer_golden, args)
    run("bert_weight_import", check_bert_weight_import, args)
    run("scene_cache", check_scene_cache, args)
    run("vqa_smoke", check_vqa_smoke, args)
    if args.multiview_nomv_data:
        run("multiview_hdf5", check_multiview_hdf5, args)
    else:
        checks["multiview_hdf5"] = {"status": "skipped",
                                    "reason": "needs --multiview_nomv_data"}

    env = None
    if (args.scannet_data and args.scanrefer_dir
            and _scene_id(args) is not None):
        try:
            env = _build_predict_env(args)
        except Exception as exc:  # noqa: BLE001
            checks["predict_contract"] = {
                "status": "fail", "error": repr(exc),
                "traceback": traceback.format_exc()[-1500:],
            }
    if env is not None:
        run("predict_contract", check_predict_contract, args, env)
        run("grounding_acc", check_grounding_acc, args, env)
        run("caption_smoke", check_caption_smoke, args, env)
        run("torch_import_chain", check_torch_import_chain, args, env)
    else:
        for name in ("predict_contract", "grounding_acc", "caption_smoke",
                     "torch_import_chain"):
            checks.setdefault(name, {
                "status": "skipped",
                "reason": "needs --scannet_data and --scanrefer_dir",
            })

    ok = all(c["status"] != "fail" for c in checks.values())
    report = {"ok": ok, "checks": checks}
    with open(args.out, "w") as f:
        json.dump(report, f, indent=2)
    summary = " ".join(f"{name}={c['status']}" for name, c in checks.items())
    print(f"vlp3d_torch validate: {'OK' if ok else 'FAIL'} ({summary}) "
          f"-> {args.out}")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
