"""DexYCB-MV dataset (counterpart of handmvnet_tpu/data/dexycb.py).

The reference imports a DexYCBDataModule but ships none (reference
train.py:8, README.md:56). The contract of its notebooks and configs: 8
camera views, root camera 2, HO3D's tar sample schema, 640 x 480 frames.
Its split sizes are config.SPLIT_SIZES["dexycb"].
"""

from __future__ import annotations

from handmvnet_tpu_torch.data.ho3d import MultiviewTarDataset


class DexYCBDataset(MultiviewTarDataset):
    name = "dexycb"
    root_idx = 2
    train_pattern = "DexYCB_mv_train-{000000..000099}.tar"
    test_pattern = "DexYCB_mv_test-{000000..000019}.tar"
