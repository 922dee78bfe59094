"""Dense-captioning (Scan2Cap) evaluation pipeline.

The port's own copy of ``vlp3d/eval/captioning.py`` (numpy only).

Port of `lib/joint/eval_helper.py:24-357`: build the reference corpus from
ScanRefer, run greedy decoding per proposal, keep NMS-surviving proposals
whose box matches its assigned GT with IoU > 0.5, decode to
"[CLS] ... [SEP]" strings keyed `scene|object_id|object_name`, score with
BLEU-4 / CIDEr / ROUGE-L / METEOR @0.5.
"""

from __future__ import annotations

import numpy as np

from vlp3d_torch.eval.box_iou import box3d_iou, get_3d_box
from vlp3d_torch.eval.capeval import Bleu, Cider, Meteor, Rouge
from vlp3d_torch.eval.detection import parse_predictions


def prepare_corpus(scanrefer: list, max_len: int = 30) -> dict:
    """key 'scene|object_id|object_name' -> list of framed descriptions
    (eval_helper.py:24-44)."""
    corpus: dict = {}
    for data in scanrefer:
        token = data["token"][:max_len]
        description = "[CLS] " + " ".join(token) + " [SEP]"
        key = "{}|{}|{}".format(
            data["scene_id"], data["object_id"], data["object_name"]
        )
        corpus.setdefault(key, []).append(description)
    return corpus


def organize_scanrefer(scanrefer: list) -> dict:
    """scene -> object_id -> ann_id -> annotation (the 'organized' json)."""
    out: dict = {}
    for data in scanrefer:
        out.setdefault(data["scene_id"], {}).setdefault(
            data["object_id"], {}
        )[data["ann_id"]] = data
    return out


def decode_caption(tokenizer, ids) -> str:
    """'[CLS] tokens... [SEP]' framing with '.' split out
    (eval_helper.py:47-55).

    Replicates the reference's HF decode string algebra exactly when the
    tokenizer exposes its vocab (BertWordPieceTokenizer): join ALL
    tokens (specials included), merge wordpieces via replace(' ##', '')
    — which also glues a leading continuation piece onto '[CLS]', an HF
    quirk the reference's candidates carry — then the tokenization
    cleanup (',?!' and contractions glue onto the previous word, so
    candidates contain 'corner,' while the corpus keeps 'corner ,'),
    '.' split back out, and truncation after the first '[SEP]'
    (eval_helper.py:47-55). A per-token decode loop previously leaked
    raw '##' pieces into the candidate strings
    (tests/test_refparity_caption_eval.py)."""
    ids = np.asarray(ids).reshape(-1).tolist()
    inv = getattr(tokenizer, "inv_vocab", None)
    if inv is not None:
        text = " ".join(inv.get(int(i), "[UNK]") for i in ids)
        text = text.replace(" ##", "")
    else:  # hash-vocab path: synthesize the same framing
        text = "[CLS] " + tokenizer.decode(ids) + " [SEP]"
    for a, b in (
        (" .", "."), (" ?", "?"), (" !", "!"), (" ,", ","),
        (" ' ", "'"), (" n't", "n't"), (" 'm", "'m"), (" 's", "'s"),
        (" 've", "'ve"), (" 're", "'re"),
    ):
        text = text.replace(a, b)
    text = text.replace(".", " .")
    pos = text.find("[SEP]")
    text = text[: pos + 5] if pos != -1 else text + " [SEP]"
    return " ".join(text.split())


def collect_caption_candidates(
    outputs: dict,
    batch: dict,
    tokenizer,
    organized: dict,
    *,
    object_assignment: np.ndarray,
    min_iou: float = 0.5,
    candidates: dict | None = None,
) -> dict:
    """One batch of eval outputs -> candidate captions
    (feed_scene_cap, eval_helper.py:79-275).

    outputs needs: lang_cap_ids (B, K, T), pred_center/size/heading,
    objectness_scores, sem_cls_scores; point_clouds via batch. batch needs:
    gt_box_corner_label, scene_object_ids, scene_id list. Predicted corners
    are reconstructed HERE on host (numpy) — the jitted forward does not
    emit corner tensors.
    """
    candidates = candidates if candidates is not None else {}
    pred_mask, _ = parse_predictions(
        {**outputs, "point_clouds": batch["point_clouds"]}, {}
    )
    obj_mask = np.argmax(np.asarray(outputs["objectness_scores"]), -1)
    nms_masks = pred_mask * obj_mask

    scene_object_ids = np.asarray(batch["scene_object_ids"])
    detected_object_ids = np.take_along_axis(
        scene_object_ids, object_assignment, axis=1
    )
    gt_corners = np.take_along_axis(
        np.asarray(batch["gt_box_corner_label"]),
        object_assignment[:, :, None, None],
        axis=1,
    )
    pc = np.asarray(outputs["pred_center"])
    ps = np.asarray(outputs["pred_size"])
    ph = np.asarray(outputs["pred_heading"])
    pred_corners = np.stack(
        [
            np.stack(
                [get_3d_box(ps[i, j], float(ph[i, j]), pc[i, j])
                 for j in range(pc.shape[1])]
            )
            for i in range(pc.shape[0])
        ]
    )
    ious = box3d_iou(gt_corners, pred_corners)  # (B, K) AABB corner IoU
    good = ious > min_iou

    captions = np.asarray(outputs["lang_cap_ids"])  # (B, K, T)
    b, k = captions.shape[:2]
    scene_ids = batch["scene_id"]
    for i in range(b):
        scene_id = scene_ids[i]
        for j in range(k):
            if nms_masks[i, j] != 1 or not good[i, j]:
                continue
            object_id = str(int(detected_object_ids[i, j]))
            decoded = decode_caption(tokenizer, captions[i, j])
            try:
                anns = organized[scene_id][object_id]
                object_name = next(iter(anns.values()))["object_name"]
            except (KeyError, StopIteration):
                continue
            key = f"{scene_id}|{object_id}|{object_name}"
            candidates[key] = [decoded]
    return candidates


def score_captions(corpus: dict, candidates: dict) -> dict:
    """check/organize candidates + run the 4 scorers
    (eval_cap, eval_helper.py:278-357)."""
    full = {k: candidates.get(k, ["[CLS] [SEP]"]) for k in corpus}
    bleu, _ = Bleu(4).compute_score(corpus, full)
    cider, _ = Cider().compute_score(corpus, full)
    rouge, _ = Rouge().compute_score(corpus, full)
    meteor, _ = Meteor().compute_score(corpus, full)
    return {
        "bleu-1": bleu[0],
        "bleu-2": bleu[1],
        "bleu-3": bleu[2],
        "bleu-4": bleu[3],
        "cider": cider,
        "rouge": rouge,
        "meteor": meteor,
    }
