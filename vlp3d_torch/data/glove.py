"""GloVe-era description features (legacy 3DJCG task pipelines).

The port's own copy of ``vlp3d/data/glove.py`` (numpy; the same inputs
give the same arrays, bit for bit). Ports `lib/visual_grounding/dataset.py:457-535` (`_tranform_des`): per
annotation, a (MAX_DES_LEN, 300) matrix of GloVe vectors —
glove[token] with glove["pad"] fallback — plus the "main" clause
features (tokens up to the first ".", unk fallback), the clause length,
and `first_obj`: the first token index whose raw label (with a two-word
lookahead) matches the referred object's class.

The glove.p pickle is an external asset (same as the reference);
`load_glove` accepts the pickle path or a prebuilt dict, and
`synthetic_glove` builds a deterministic stand-in for tests.
"""

from __future__ import annotations

import pickle

import numpy as np

GLOVE_DIM = 300


def load_glove(path_or_dict) -> dict:
    if isinstance(path_or_dict, dict):
        return path_or_dict
    with open(path_or_dict, "rb") as f:
        return pickle.load(f)


def synthetic_glove(words, dim: int = GLOVE_DIM, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    table = {w: rng.normal(size=(dim,)).astype(np.float32) for w in words}
    table.setdefault("pad", np.zeros((dim,), np.float32))
    table["unk"] = rng.normal(size=(dim,)).astype(np.float32)
    return table


def transform_description(
    tokens: list,
    object_name: str,
    glove: dict,
    raw2label: dict,
    max_des_len: int = 30,
):
    """One annotation -> dict with embeddings/main_embeddings
    (max_des_len, GLOVE_DIM), lang_len, main_len, first_obj."""
    dim = len(glove["unk"])
    emb = np.zeros((max_des_len, dim), np.float32)
    main_emb = np.zeros((max_des_len, dim), np.float32)
    pd = 1
    main_len = None
    first_obj = -1
    main_object_cat = raw2label.get(object_name, 17)
    for ti in range(max_des_len):
        if ti >= len(tokens):
            continue
        token = tokens[ti]
        emb[ti] = glove.get(token, glove["pad"])
        if pd == 1:
            main_emb[ti] = glove.get(token, glove["unk"])
            if token == ".":
                pd = 0
                main_len = ti + 1
        object_cat = raw2label.get(token, -1)
        is_two_words = 0
        if ti + 1 < len(tokens):
            cat_new = raw2label.get(token + " " + tokens[ti + 1], -1)
            if cat_new != -1:
                object_cat = cat_new
                is_two_words = 1
        if first_obj == -1 and object_cat == main_object_cat:
            first_obj = ti + 1 if (is_two_words and ti + 1 < len(tokens)) else ti
    if main_len is None:
        main_len = len(tokens)
    return {
        "embeddings": emb,
        "main_embeddings": main_emb,
        "lang_len": min(len(tokens), max_des_len),
        "main_len": main_len,
        "first_obj": first_obj,
    }


def transform_descriptions(
    scanrefer: list, glove: dict, raw2label: dict, max_des_len: int = 30
):
    """All annotations -> nested {scene_id: {object_id: {ann_id: feats}}}
    (the reference's `lang` / `lang_main` structures merged)."""
    lang: dict = {}
    for data in scanrefer:
        feats = transform_description(
            data["token"], data["object_name"], glove, raw2label, max_des_len
        )
        lang.setdefault(data["scene_id"], {}).setdefault(
            str(data["object_id"]), {}
        )[str(data["ann_id"])] = feats
    return lang


def glove_batch_fields(
    chunk: list, lang: dict, lang_num_max: int, max_des_len: int = 30
):
    """Fixed-shape per-chunk GloVe fields for the task datasets:
    lang_feat (L, T, 300), lang_len (L,), main_lang_feat, main_lang_len,
    first_obj (mirrors dataset.py:134-162)."""
    dim = GLOVE_DIM
    any_feats = None
    lf = np.zeros((lang_num_max, max_des_len, dim), np.float32)
    ml = np.zeros((lang_num_max, max_des_len, dim), np.float32)
    ll = np.zeros((lang_num_max,), np.int32)
    mll = np.zeros((lang_num_max,), np.int32)
    fo = np.full((lang_num_max,), -1, np.int32)
    for j in range(lang_num_max):
        data = chunk[min(j, len(chunk) - 1)]
        feats = lang[data["scene_id"]][str(data["object_id"])][
            str(data["ann_id"])
        ]
        dim = feats["embeddings"].shape[-1]
        if any_feats is None:
            lf = np.zeros((lang_num_max, max_des_len, dim), np.float32)
            ml = np.zeros((lang_num_max, max_des_len, dim), np.float32)
            any_feats = True
        lf[j] = feats["embeddings"]
        ml[j] = feats["main_embeddings"]
        ll[j] = feats["lang_len"]
        mll[j] = feats["main_len"]
        fo[j] = feats["first_obj"]
    return {
        "lang_feat": lf,
        "lang_len": ll,
        "main_lang_feat": ml,
        "main_lang_len": mll,
        "first_obj": fo,
    }


def transform_description_caption(
    tokens: list, glove: dict, vocabulary: dict, max_des_len: int = 30
):
    """Captioning-era transform (lib/visual_captioning/dataset.py:157-176):
    tokens are sos/eos-wrapped; returns embeddings (max_des_len+2, 300),
    lang_ids (max_des_len+2,) in caption-vocab space (unk fallback), and
    lang_len = len(tokens)+2 capped."""
    word2idx = vocabulary["word2idx"]
    toks = ["sos"] + list(tokens)[:max_des_len] + ["eos"]
    t = max_des_len + 2
    dim = len(glove["unk"])
    emb = np.zeros((t, dim), np.float32)
    ids = np.zeros((t,), np.int64)  # 0 = pad_
    for ti, token in enumerate(toks[:t]):
        emb[ti] = glove.get(token, glove["unk"])
        ids[ti] = word2idx.get(token, word2idx["unk"])
    return {
        "cap_embeddings": emb,
        "lang_ids": ids,
        "cap_len": min(len(toks), t),
    }


def caption_batch_fields(
    chunk: list, cap_lang: dict, lang_num_max: int, max_des_len: int = 30
):
    """Per-chunk captioning fields: cap_lang_feat (L, T+2, 300),
    lang_ids (L, T+2), cap_len (L,)."""
    t = max_des_len + 2
    first = next(iter(next(iter(next(iter(cap_lang.values())).values())).values()))
    dim = first["cap_embeddings"].shape[-1]
    lf = np.zeros((lang_num_max, t, dim), np.float32)
    ids = np.zeros((lang_num_max, t), np.int64)
    ln = np.zeros((lang_num_max,), np.int32)
    for j in range(lang_num_max):
        data = chunk[min(j, len(chunk) - 1)]
        feats = cap_lang[data["scene_id"]][str(data["object_id"])][
            str(data["ann_id"])
        ]
        lf[j] = feats["cap_embeddings"]
        ids[j] = feats["lang_ids"]
        ln[j] = feats["cap_len"]
    return {"cap_lang_feat": lf, "lang_ids": ids, "cap_len": ln}
