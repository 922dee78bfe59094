"""Configuration tree for the PyTorch port.

The port's own copy of the dataclasses in ``vlp3d/config.py``
(``DatasetConfig``, ``ModelConfig``, ``LossConfig``, ``TrainConfig``,
``Config``): same fields, same defaults, so a config written for one
package reads the same in the other. The port imports nothing from
``vlp3d``.

Every grounding, captioning and question-answering flag is implemented
(inference and the joint train step), ``use_mlcv_net`` included;
:func:`check_supported` refuses the combinations the model cannot build.
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
class LossConfig:
    """Weights from get_joint_loss (lib/loss_helper/loss_joint.py:160-224)."""

    detection_scale: float = 10.0
    objectness_weight: float = 0.1
    ref_weight_before_50: float = 0.3
    ref_weight_after_50: float = 1.0
    diou_weight: float = 0.3
    kl_weight: float = 0.3
    lang_weight: float = 0.3
    attr_weight: float = 0.3
    vote_weight_weight: float = 0.3
    lang_con_weight: float = 0.5
    iou_con_weight: float = 2.5
    mlm_weight: float = 10.0
    num_ground_epoch: int = 50
    use_diou_loss: bool = True
    use_attr_loss: bool = False
    # --debug diagnostics inside the OID loss (per-class IoU rates,
    # top-k IoU stats, top_ind; loss_grounding.py:262-306)
    debug: bool = False


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 8
    epochs: int = 200
    lr: float = 2e-3
    module_lr: float = 5e-4  # lang/relation/match/caption groups
    weight_decay: float = 1e-5
    amsgrad: bool = False  # AMSGrad AdamW variant (scripts/utils/AdamW.py)
    # "adamw" (joint path, vendored AdamW) | "adam" (VQA paths' default:
    # coupled L2, scripts/joint_scripts/train_qa.py:145-159)
    optim_name: str = "adamw"
    # one param group at `lr` (the VQA scripts' model.parameters())
    # instead of the joint lang/relation/match/caption split
    single_lr_group: bool = False
    # clip raw gradient VALUES (nn.utils.clip_grad_value_, the VQA
    # solver's default 1.0; 0 disables)
    clip_grad_value: float = 0.0
    # "cosine" | "step" | "none" (train_3dvlp.py:180-196: --coslr ->
    # cosine; detection-only without --coslr -> MultiStepLR; else none)
    lr_schedule: str = "cosine"
    coslr_eta_min: float = 1e-5
    lr_decay_steps: tuple = (80, 120, 160)  # LR_DECAY_STEP (no_caption)
    lr_decay_rate: float = 0.1
    bn_momentum_init: float = 0.5  # torch convention; halved every 20 epochs
    bn_decay_step: int = 20
    bn_momentum_min: float = 1e-3
    seed: int = 42
    # loader worker threads (reference DataLoader num_workers=4,
    # train_3dvlp.py:48-77); batch stream is identical for any value
    num_workers: int = 4


@dataclasses.dataclass(frozen=True)
class Config:
    dataset: DatasetConfig = DatasetConfig()
    model: ModelConfig = ModelConfig()
    loss: LossConfig = LossConfig()
    train: TrainConfig = TrainConfig()


# the SA/FP point MLPs' compute dtypes (ModelConfig.compute_dtype)
COMPUTE_DTYPES = ("float32", "bfloat16")


def check_supported(config: Config) -> None:
    """Raise ValueError for a compute dtype the port does not know or a
    head that reads the grounding branch of a ``no_reference`` model."""
    cfg = config.model
    if cfg.compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(
            f"compute_dtype={cfg.compute_dtype!r}: the point MLPs compute "
            f"in one of {COMPUTE_DTYPES}")
    if cfg.no_reference and cfg.use_answer:
        raise ValueError(
            "use_answer reads the match module's cross_box_feature, which "
            "a no_reference model does not build")
