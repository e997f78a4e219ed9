"""Typed configuration (the port's copy of handmvnet_tpu/config.py).

Frozen dataclasses that accept the release YAMLs (configs/release/*.yaml)
verbatim through ``Config.from_yaml``. Inference reads ``model`` and the
image sizes of ``data``; training reads ``train`` and the batch size too.
Fields the port does not use yet (the loader's, remat) are kept so that the
YAMLs load.

The YAML is read by a small parser of the block subset the configs use
(nested mappings, lists of scalars, plain or quoted scalars), so that the
port needs no YAML package on the machine with the card; anything outside
that subset is refused rather than misread.
"""

from __future__ import annotations

import dataclasses
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Mapping, Sequence

_INT = re.compile(r"^[-+]?[0-9]+$")
_FLOAT = re.compile(r"^[-+]?([0-9]+\.[0-9]*|\.[0-9]+)([eE][-+]?[0-9]+)?$")

# samples per split of each dataset (the reference's fixed epoch sizes)
SPLIT_SIZES = {
    "ho3d": {"train": 7718, "train+val": 9087, "val": 1369, "test": 2706},
    "dexycb": {"train": 25588, "train+val": 28935, "val": 3347, "test": 4950},
    "mvhand": {"train": 960, "train+val": 1200, "val": 240, "test": 480},
}


def _scalar(text: str) -> Any:
    if text and text[0] in "[{&*|>!%@`":
        raise ValueError(f"YAML construct outside the configs' subset: {text!r}")
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "'\"":
        return text[1:-1]
    if text in ("true", "True"):
        return True
    if text in ("false", "False"):
        return False
    if text in ("null", "~", ""):
        return None
    if _INT.match(text):
        return int(text)
    if _FLOAT.match(text):
        return float(text)
    return text


def parse_yaml(source: str) -> dict:
    """Block-style YAML of mappings and lists of scalars -> nested dicts."""
    lines = []
    for raw in source.splitlines():
        if "\t" in raw:
            raise ValueError("tabs in YAML indentation")
        text = raw.strip()
        if text and not text.startswith("#") and text != "---":
            lines.append((len(raw) - len(raw.lstrip(" ")), text))

    def block(i: int, indent: int) -> tuple[Any, int]:
        if lines[i][1].startswith("- "):
            items = []
            while i < len(lines) and lines[i][0] == indent and lines[i][1].startswith("- "):
                items.append(_scalar(lines[i][1][2:].strip()))
                i += 1
            return items, i
        mapping = {}
        while i < len(lines) and lines[i][0] == indent and not lines[i][1].startswith("- "):
            key, sep, rest = lines[i][1].partition(":")
            if not sep:
                raise ValueError(f"not a 'key: value' line: {lines[i][1]!r}")
            i += 1
            rest = rest.strip()
            nested = i < len(lines) and (
                lines[i][0] > indent or (lines[i][0] == indent and lines[i][1].startswith("- ")))
            if not rest and nested:
                mapping[key.strip()], i = block(i, lines[i][0])
            else:
                mapping[key.strip()] = _scalar(rest)
        return mapping, i

    if not lines:
        return {}
    data, end = block(0, lines[0][0])
    if end != len(lines):
        raise ValueError(f"unparsed YAML from line {lines[end][1]!r}")
    return data


@dataclass(frozen=True)
class LRSchedulerConfig:
    gamma: float = 0.5
    milestones: tuple[int, ...] = (15, 30, 45, 60)


@dataclass(frozen=True)
class DataConfig:
    name: str = "ho3d"
    batch_size: int = 16
    dataset_dir: str = "data/ho3d"
    mask_size: int = 32
    depth_size: int = 32
    heatmap_size: int = 32
    image_size: int = 256
    mano_models_dir: str = "mano"
    num_workers: int = 6
    augment: bool = True
    decode_scale_denom: int = 1
    cache_decoded: bool = False
    cache_dir: str = ""
    pad_image: bool = True
    add_val_to_train: bool = False
    selected_views: tuple[int, ...] = (0, 1, 2, 3, 4)
    mask_invisible_joints: bool = True
    split_size_overrides: Mapping[str, int] | None = None

    @property
    def num_views(self) -> int:
        return len(self.selected_views)

    def split_size(self, split: str) -> int:
        """Samples in a split of the dataset: the reference's fixed epoch
        sizes, which size every epoch and the LR milestones, with the
        overrides; "train" includes "val" under add_val_to_train."""
        sizes = dict(SPLIT_SIZES[self.name])
        sizes.update(self.split_size_overrides or {})
        if split == "train" and self.add_val_to_train:
            split = "train+val"
        return sizes[split]


@dataclass(frozen=True)
class ModelConfig:
    selected_views: tuple[int, ...] = (0, 1, 2, 3, 4)
    fusion: str = "cross_attn"
    fusion_layers: int = 5
    pos_enc: tuple[str, ...] = ("pos2d", "crop", "sin")
    use_gcn: bool = True
    backbone: str = "resnet"
    backbone_type: str = "50_paper"
    backbone_early_return: int = 3
    backbone_channels: tuple[int, ...] = (1024,)
    backbone_pretrained: bool = True
    backbone_pretrained_path: str = ""
    freeze_bn: bool = False
    get_vertices: bool = False
    num_joints: int = 21
    hrnet_branch_grouped: bool = False
    resnet_stem_s2d: bool = True
    backbone_int8: bool = False

    @property
    def num_views(self) -> int:
        return len(self.selected_views)

    @property
    def feat_dim(self) -> int:
        """Token width entering the fusion: sum(backbone_channels)/2 from the
        SampleNets, +2 raw 2D coords, +10 crop-FoV angles."""
        d = int(sum(self.backbone_channels) / 2)
        if "pos2d" in self.pos_enc:
            d += 2
        if "crop" in self.pos_enc:
            d += 10
        return d


@dataclass(frozen=True)
class LossWeights:
    heatmap: float = 10.0
    joints_2d: float = 1.0
    joints_3d: float = 1000.0
    g2d: float | None = 1.0
    p2d: float | None = 0.5


@dataclass(frozen=True)
class TrainConfig:
    debug: bool = False
    vis_every_n_epochs: int = 10
    epochs: int = 100
    accumulate_batch: int = 2
    gpus: int = 1
    mask_invisible_joints: bool = True
    root_relative: bool = True
    loss_weights: LossWeights = field(default_factory=LossWeights)
    lr: float = 1e-4
    lr_scheduler: LRSchedulerConfig = field(default_factory=LRSchedulerConfig)
    weight_decay: float = 0.05
    grad_clip: float = 1.0
    seed: int = 42
    compute_dtype: str = "float32"
    num_devices: int = 0
    remat: str = "auto"


@dataclass(frozen=True)
class Config:
    name: str = "handmvnet"
    base_output_dir: str = "./outputs/debug"
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)

    @property
    def auc_thresholds(self) -> tuple[float, float]:
        """The dataset's PCK-AUC threshold range, metres."""
        return {"dexycb": (0.0, 0.02), "ho3d": (0.0, 0.05), "mvhand": (0.0, 0.02)}[self.data.name]

    @property
    def root_idx(self) -> int:
        """The dataset's root camera (the view whose frame the 3D labels use)."""
        return {"ho3d": 0, "dexycb": 2, "mvhand": 3}[self.data.name]

    @staticmethod
    def from_yaml(path: str | Path) -> "Config":
        return Config.from_dict(parse_yaml(Path(path).read_text()))

    @staticmethod
    def from_dict(raw: Mapping[str, Any]) -> "Config":
        raw = dict(raw)
        model_raw = dict(raw.get("model", {}))
        data_raw = dict(raw.get("data", {}))
        train_raw = dict(raw.get("train", {}))

        # the reference copies these from model into data
        if "selected_views" in model_raw:
            data_raw.setdefault("selected_views", model_raw["selected_views"])
        if "mask_invisible_joints" in train_raw:
            data_raw.setdefault("mask_invisible_joints", train_raw["mask_invisible_joints"])

        lw_raw = dict(train_raw.pop("loss_weights", {}))
        sched_raw = dict(train_raw.pop("lr_scheduler", {}))
        return Config(
            name=raw.get("name", "handmvnet"),
            base_output_dir=raw.get("base_output_dir", "./outputs/debug"),
            data=_build(DataConfig, data_raw),
            model=_build(ModelConfig, model_raw),
            train=dataclasses.replace(
                _build(TrainConfig, train_raw),
                loss_weights=_build(LossWeights, lw_raw, fill_missing_none=("g2d", "p2d")),
                lr_scheduler=_build(LRSchedulerConfig, sched_raw),
            ),
        )

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def _build(cls, raw: Mapping[str, Any], fill_missing_none: Sequence[str] = ()):
    """Construct a dataclass from a raw dict, ignoring unknown keys and
    turning lists into tuples. Keys in fill_missing_none default to None
    when absent."""
    names = {f.name for f in dataclasses.fields(cls)}
    kwargs = {k: tuple(v) if isinstance(v, list) else v for k, v in raw.items() if k in names}
    for key in fill_missing_none:
        if key not in raw and key in names:
            kwargs[key] = None
    return cls(**kwargs)
