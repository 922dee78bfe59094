"""Configuration tree for the PyTorch port.

The port's own copy of the dataclasses in ``vlp3d/config.py``
(``DatasetConfig``, ``ModelConfig``, ``Config``): same fields, same
defaults, so a config written for one package reads the same in the
other. The port imports nothing from ``vlp3d``.

Only the grounding-inference flags are implemented so far;
:func:`check_supported` names the ROADMAP item that ports each other one.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Sequence

import numpy as np

# ScanNet 18-class taxonomy (data/scannet/model_util_scannet.py:84-88)
SCANNET_TYPES = (
    "cabinet", "bed", "chair", "sofa", "table", "door", "window",
    "bookshelf", "picture", "counter", "desk", "curtain", "refrigerator",
    "shower curtain", "toilet", "sink", "bathtub", "others",
)


@dataclasses.dataclass(frozen=True)
class DatasetConfig:
    """ScanNet dataset constants (model_util_scannet.py:82-190)."""

    num_class: int = 18
    num_heading_bin: int = 1  # ScanNet boxes are axis-aligned
    num_size_cluster: int = 18
    max_num_obj: int = 256  # MAX_NUM_OBJ padding (lib/joint/dataset.py)
    num_points: int = 40000  # sampled per scene (train_3dvlp.py:619)
    mean_size_path: str = ""  # scannet_reference_means.npz location

    def mean_size_arr(self) -> np.ndarray:
        if self.mean_size_path and os.path.exists(self.mean_size_path):
            return np.load(self.mean_size_path)["arr_0"].astype(np.float32)
        # deterministic placeholder until the asset is provided
        return np.ones((self.num_size_cluster, 3), np.float32)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    input_feature_dim: int = 132  # multiview 128 + normals 3 + height 1
    num_proposal: int = 256
    # PointNet++ SA geometry (backbone_module.py:29-63)
    sa_npoints: Sequence[int] = (2048, 1024, 512, 256)
    sa_radii: Sequence[float] = (0.2, 0.4, 0.8, 1.2)
    sa_nsamples: Sequence[int] = (64, 32, 16, 16)
    vote_factor: int = 1
    hidden_size: int = 128
    lang_num_max: int = 8  # sentences per scene chunk
    bert_seq_len: int = 50  # CONF.BERT_MAX_LEN (lib/configs/config.py:69)
    vocab_size: int = 30522
    max_des_len: int = 30  # caption decode length (config_joint.py)
    fusion_layer: int = 6  # BERT text-mode depth
    use_distil: bool = False  # DistilBERT text encoder (--use_distil)
    compute_dtype: str = "float32"  # SA/FP MLP compute dtype
    remat: bool = False  # backward-pass rematerialisation (training only)
    num_answers: int = 8192
    # multiview feature channels inside point_clouds, consumed by the
    # relation module (relation_module.py:101-102)
    multiview_offset: int = 6
    multiview_dim: int = 128
    # bit-exact replication of the reference's scrambled relation
    # obj-feature gather (relation_module.py:101-117)
    reference_obj_gather: bool = False

    # feature toggles mirroring the reference's flags
    no_caption: bool = True
    use_con: bool = True
    use_mlm: bool = False
    use_lang_emb: bool = False
    use_answer: bool = False
    use_reg_head: bool = False
    use_kl_loss: bool = False
    use_vote_weight: bool = False
    mask_box: bool = False
    use_lang_classifier: bool = True
    no_reference: bool = False
    use_mlcv_net: bool = False  # CGNL voting variant (jointnet.py:63-69)


@dataclasses.dataclass(frozen=True)
class Config:
    dataset: DatasetConfig = DatasetConfig()
    model: ModelConfig = ModelConfig()


_SLICE1_OPTIONS = "ROADMAP.md queue A item 9a (options of slice 1)"
# flag -> (value that is not ported yet, the ROADMAP item that ports it).
# use_con is served as-is: the contrast head only feeds training losses
# and is skipped at inference, which is all the port runs so far.
_UNPORTED = {
    "use_answer": (True, "ROADMAP.md queue A item 17 (VQA)"),
    "use_mlm": (True, "ROADMAP.md queue A item 16 (captioning/MLM)"),
    "no_caption": (False, "ROADMAP.md queue A item 16 (captioning/MLM)"),
    "use_mlcv_net": (True, "ROADMAP.md queue A item 20 (variant models)"),
    "use_distil": (True, _SLICE1_OPTIONS),
    "use_lang_emb": (True, _SLICE1_OPTIONS),
    "use_reg_head": (True, _SLICE1_OPTIONS),
    "use_vote_weight": (True, _SLICE1_OPTIONS),
    "mask_box": (True, _SLICE1_OPTIONS),
    "reference_obj_gather": (True, _SLICE1_OPTIONS),
    "use_kl_loss": (True, _SLICE1_OPTIONS),
    "use_lang_classifier": (False, _SLICE1_OPTIONS),
    "no_reference": (True, _SLICE1_OPTIONS),
}


def check_supported(config: Config) -> None:
    """Raise NotImplementedError for a model flag the port lacks."""
    cfg = config.model
    for flag, (bad, item) in _UNPORTED.items():
        if getattr(cfg, flag) == bad:
            raise NotImplementedError(
                f"vlp3d_torch does not implement {flag}={bad} yet; see {item}"
            )
    if cfg.compute_dtype != "float32":
        raise NotImplementedError(
            f"vlp3d_torch computes in float32 only (compute_dtype="
            f"{cfg.compute_dtype!r}); see {_SLICE1_OPTIONS}"
        )
