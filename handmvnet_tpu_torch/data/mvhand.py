"""MVHand dataset (counterpart of handmvnet_tpu/data/mvhand.py).

Imported but absent upstream, like DexYCB (reference train.py:9). The
contract of the notebooks: 4 camera views, root camera 3, HO3D's tar sample
schema. Its split sizes are config.SPLIT_SIZES["mvhand"].
"""

from __future__ import annotations

from handmvnet_tpu_torch.data.ho3d import MultiviewTarDataset


class MVHandDataset(MultiviewTarDataset):
    name = "mvhand"
    root_idx = 3
    train_pattern = "MVHand_mv_train-{000000..000009}.tar"
    test_pattern = "MVHand_mv_test-{000000..000002}.tar"
