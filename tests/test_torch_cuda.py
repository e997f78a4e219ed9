"""The port's CUDA kernels against their plain PyTorch versions, their
autograd Functions against autograd through the plain versions, a training
step through both kernels, the HRNet model's forward and training step
through K1, the mesh stage against the CPU, and the data path (nvJPEG
against libjpeg's pixels, make_device_prepare against the CPU, one eval
batch through both kernels, the downscaled decode against the CPU, the
decode cache's store against nvJPEG's decode), on the card.

Marked ``cuda``: they skip on a machine without a CUDA device (a kernel
written in CUDA has no CPU mode). On a host with an NVIDIA Hopper GPU:
``python -m pytest tests/test_torch_cuda.py -q``. chip_smoke.py runs the same
comparisons at the main path's shapes and times them.

Tolerances (max |kernel - plain|):
  fp32 attention  2e-5, tests/test_pallas_attention.py's forward tolerance;
  fp32 stem       1e-5 * max|plain|: 147-term f32 sums in another order;
                  both fp32 kernels run their products in 3xTF32, which
                  keeps these (tests/test_torch_tf32x3.py emulates it);
  bf16 stem       2^-6 * max|plain|: both sides round one f32 sum of bf16
                  products to bf16, so they differ by an ulp or two of the
                  largest value;
  bf16 attention  2^-6 * max|plain|: the kernels also round the softmax
                  weights p to bf16 before the p v product, as the Pallas
                  kernel does (handmvnet_tpu/ops/pallas/attention.py:46), where
                  the plain version keeps them f32 ("query_tiles" rounds the
                  normalised p, as Pallas; "key_split" the running one). That
                  adds a relative 2^-9 to each weight, well under the bound
                  (the JAX package's own bf16 kernel is held to the same 2^-6
                  in tests/test_torch_attention.py).
K1 has two designs (ops/attention.py::attention_design picks): each is held
to the plain version directly (launch_design), at the shapes where the rule
picks it and at its edges.
Backwards (PyTorch ops, as the JAX package has no backward kernel): the
Functions' gradients against autograd through the plain versions, fp32 1e-5
(stem: 1e-5 x max), bf16 2^-6 x max. TF32 is switched off so that the plain
fp32 versions are fp32.
"""

import ctypes

import pytest
import torch

from handmvnet_tpu_torch.ops import _build
from handmvnet_tpu_torch.ops.attention import (
    DESIGNS, TILE_MAX_KEYS, attention_design, attention_plain, fused_attention, launch_design)
from handmvnet_tpu_torch.ops.stem import stem_conv_nchw, stem_conv_plain, stem_routes

pytestmark = pytest.mark.cuda


@pytest.fixture
def card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    return torch.device("cuda")


def _tol(dtype, ref, fp32_tol):
    return fp32_tol if dtype == torch.float32 else 2.0 ** -6 * float(ref.abs().max())


# the main path's (Nq, Nk) at batch 1, then the kernels' edges: a full
# and a ragged 16-row query tile; Nk = 5 leaves three of its four warps
# without keys, Nk = 300 takes two passes over each warp's key slice; batch 2
# walks the batch stride
ATTN_CASES = [(1, 168, 168), (1, 21, 147), (1, 21, 21), (1, 1, 1), (1, 40, 33)] + [
    (b, nq, nk) for b in (1, 2) for nq in (16, 17) for nk in (5, 300)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("batch,nq,nk", ATTN_CASES)
def test_attention_kernel_matches_plain(card, dtype, batch, nq, nk):
    g = torch.Generator(card).manual_seed(batch * 10000 + nq * 1000 + nk)
    # the model's layout: [b, n, h, d] projections viewed as [b, h, n, d]
    q, k, v = (torch.randn(batch, n, 8, 128, generator=g, device=card).to(dtype).transpose(1, 2)
               for n in (nq, nk, nk))
    before = fused_attention.launches
    out = fused_attention(q, k, v, 128 ** -0.5)
    torch.cuda.synchronize()
    assert fused_attention.launches == before + 1
    ref = attention_plain(q, k, v, 128 ** -0.5)
    assert out.shape == ref.shape == (batch, 8, nq, 128) and out.dtype == dtype
    err = float((out.float() - ref.float()).abs().max())
    assert err <= _tol(dtype, ref.float(), 2e-5), err


@pytest.mark.parametrize("design", DESIGNS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_attention_refuses_unaligned_rows(card, dtype, design):
    """cp.async and TMA need 16-byte rows: a row stride of 129 elements is
    refused by either design, not computed some other way."""
    q = torch.randn(1, 8, 21, 129, device=card, dtype=dtype)[..., :128]
    k = torch.randn(1, 8, 21, 128, device=card, dtype=dtype)
    with pytest.raises(RuntimeError, match="CUDA error"):
        fused_attention(q, k, k, 0.1)
    with pytest.raises(RuntimeError, match="CUDA error"):
        launch_design(q, k, k, 0.1, design)


def _qkv(card, dtype, batch, nq, nk, layout="bnhd"):
    g = torch.Generator(card).manual_seed(batch * 10000 + nq * 1000 + nk)
    if layout == "bnhd":  # the model's layout: [b, n, h, d] projections viewed as [b, h, n, d]
        return [torch.randn(batch, n, 8, 128, generator=g, device=card).to(dtype).transpose(1, 2)
                for n in (nq, nk, nk)]
    return [torch.randn(batch, 8, n, 128, generator=g, device=card).to(dtype)
            for n in (nq, nk, nk)]


def _held_to_plain(out, q, k, v, dtype):
    ref = attention_plain(q, k, v, 128 ** -0.5)
    assert out.shape == ref.shape and out.dtype == dtype and out.device.type == "cuda"
    err = float((out.float() - ref.float()).abs().max())
    assert err <= _tol(dtype, ref.float(), 2e-5), err


# "query_tiles" (csrc/attention_tiles.cu) at the batched shapes of a training
# microbatch (batch 8) and an eval batch (16), then its edges: a query tile of
# 1 row, a full and a ragged bf16 warpgroup or fp32 block (64, 65), two and a
# ragged third (128, 129); keys 1 and 5 (one 8-key tile), 176 and 177 (a
# 32-key chunk half and just over half full), the most each dtype's tile holds
# (TILE_MAX_KEYS: fp32 128, bf16 192) and one past it, and 300
TILE_CASES = ([(b, nq, nk) for b in (8, 16) for nq, nk in ((105, 105), (21, 84), (21, 21))]
              + [(2, nq, 105) for nq in (1, 64, 65, 128, 129)]
              + [(2, 40, nk) for nk in (1, 5, 128, 129, 176, 177, 192, 193, 300)])


@pytest.mark.parametrize("layout", ["bnhd", "bhnd"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("batch,nq,nk", TILE_CASES)
def test_query_tiles_kernel_matches_plain(card, dtype, batch, nq, nk, layout):
    """The "query_tiles" design called directly, on the model's strided
    [b, n, h, d] views and on contiguous [b, h, n, d] tensors; a key count
    past its tile is refused (the rule sends it to "key_split")."""
    q, k, v = _qkv(card, dtype, batch, nq, nk, layout)
    before = dict(fused_attention.design_launches)
    if nk > TILE_MAX_KEYS[dtype]:
        assert attention_design(dtype, batch, 8, nq, nk) == "key_split"
        with pytest.raises(RuntimeError, match="CUDA error"):
            launch_design(q, k, v, 128 ** -0.5, "query_tiles")
        return
    out = launch_design(q, k, v, 128 ** -0.5, "query_tiles")
    torch.cuda.synchronize()
    assert fused_attention.design_launches["query_tiles"] == before["query_tiles"] + 1
    _held_to_plain(out, q, k, v, dtype)


@pytest.mark.parametrize("design", DESIGNS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("batch,nq,nk", [(8, 105, 105), (16, 21, 84), (1, 21, 21), (8, 1, 1)])
def test_each_design_matches_plain_at_the_same_shape(card, dtype, design, batch, nq, nk):
    """Both kernels at the shapes where the rule picks one or the other."""
    q, k, v = _qkv(card, dtype, batch, nq, nk)
    _held_to_plain(launch_design(q, k, v, 128 ** -0.5, design), q, k, v, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("batch,nq,nk", [(1, 168, 168), (8, 21, 84), (16, 105, 105),
                                         (2, 21, 300)])
def test_fused_attention_launches_the_rules_design(card, dtype, batch, nq, nk):
    """The op launches what attention_design picks, and counts it by design;
    the library's tile limit is the rule's."""
    lib = _build.load("attention_tiles")
    lib.hmv_attention_tiles_max_keys.argtypes = [ctypes.c_int]
    lib.hmv_attention_tiles_max_keys.restype = ctypes.c_int
    assert lib.hmv_attention_tiles_max_keys({torch.float32: 0, torch.bfloat16: 1}[dtype]) == \
        TILE_MAX_KEYS[dtype]
    q, k, v = _qkv(card, dtype, batch, nq, nk)
    design = attention_design(dtype, batch, 8, nq, nk)
    before = dict(fused_attention.design_launches)
    out = fused_attention(q, k, v, 128 ** -0.5)
    torch.cuda.synchronize()
    assert {d: n - before[d] for d, n in fused_attention.design_launches.items()} == \
        {d: int(d == design) for d in DESIGNS}
    _held_to_plain(out, q, k, v, dtype)


def _stem_input(card, dtype, shape, layout, seed):
    n, h, w = shape
    g = torch.Generator(card).manual_seed(seed)
    if layout == "nhwc_view":  # the model's layout: an NHWC image viewed as NCHW
        x = torch.randn(n, h, w, 3, generator=g, device=card).to(dtype).permute(0, 3, 1, 2)
    else:  # contiguous NCHW: strides c = H*W, w = 1
        x = torch.randn(n, 3, h, w, generator=g, device=card).to(dtype)
    return x, (torch.randn(64, 3, 7, 7, generator=g, device=card) * 0.05).to(dtype)


# the main path's serving shape and a training microbatch's (more tiles than
# the card's warpgroups), a one-tile image, ragged and odd sizes; output
# widths 17 and 50 leave rows off 16 bytes, where the kernel stores with its
# threads instead of TMA
STEM_SHAPES = [(8, 256, 256), (40, 256, 256), (1, 16, 16), (2, 64, 96), (2, 64, 100),
               (1, 30, 34), (3, 29, 33)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", STEM_SHAPES)
@pytest.mark.parametrize("layout", ["nhwc_view", "nchw"])
def test_stem_kernel_matches_plain(card, dtype, shape, layout):
    n, h, w = shape
    x, weight = _stem_input(card, dtype, shape, layout, h * 100 + w)
    before = stem_conv_nchw.launches
    out = stem_conv_nchw(x, weight)
    torch.cuda.synchronize()
    assert stem_conv_nchw.launches == before + 1
    ref = stem_conv_plain(x, weight)
    assert out.shape == ref.shape == (n, 64, (h + 1) // 2, (w + 1) // 2)
    err = float((out.float() - ref.float()).abs().max())
    assert err <= _tol(dtype, ref.float(), 1e-5 * float(ref.float().abs().max())), err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_stem_routes(card, dtype):
    """TMA moves the main path's tensors both ways; a contiguous NCHW input,
    and output rows off 16 bytes (width 50), take the threads' copies."""
    def routes(shape, layout):
        x, _ = _stem_input(card, dtype, shape, layout, 0)
        n, _, h, w = x.shape
        return stem_routes(x, x.new_empty(n, 64, (h + 1) // 2, (w + 1) // 2))

    assert routes((8, 256, 256), "nhwc_view") == ("tma", "tma")
    assert routes((8, 256, 256), "nchw") == ("threads", "tma")
    assert routes((2, 64, 100), "nhwc_view")[1] == "threads"
    assert routes((1, 30, 34), "nchw") == ("threads", "threads")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("layout", ["nhwc_view", "nchw"])
def test_stem_kernel_keeps_nan_in_its_windows(card, dtype, layout):
    """A NaN at input (row 20, column 40) reaches exactly the outputs whose 7 x
    7 windows cover it (rows 9..11, columns 19..21); the kernel's padded taps
    read neighbouring pixels (column 40 is the padded tap of output column 22),
    and their zeroed inputs keep it out of the others."""
    x, weight = _stem_input(card, dtype, (1, 64, 64), layout, 7)
    x[0, :, 20, 40] = float("nan")
    out = stem_conv_nchw(x, weight)
    torch.cuda.synchronize()
    hit = torch.zeros(32, 32, dtype=torch.bool, device=card)
    hit[9:12, 19:22] = True  # 2 o - 3 <= 20 <= 2 o + 3 and 2 o - 3 <= 40 <= 2 o + 3
    assert torch.equal(out[0].isnan().any(0), hit)
    assert out[0, :, hit].isnan().all()
    ref = stem_conv_plain(torch.nan_to_num(x), weight)
    err = float((out.float() - ref.float())[:, :, ~hit].abs().max())
    assert err <= _tol(dtype, ref.float(), 1e-5 * float(ref.float().abs().max())), err


def test_wrappers_raise_on_what_the_kernels_do_not_take(card):
    q = torch.randn(1, 8, 21, 64, device=card)
    with pytest.raises(ValueError, match="D = 128"):
        fused_attention(q, q, q, 0.125)
    with pytest.raises(TypeError):
        fused_attention(*(torch.randn(1, 8, 21, 128, device=card, dtype=torch.float16),) * 3, 0.1)
    x = torch.randn(1, 3, 32, 32, device=card)
    with pytest.raises(ValueError):
        stem_conv_nchw(x, torch.randn(32, 3, 7, 7, device=card))
    with pytest.raises(TypeError):
        stem_conv_nchw(x, torch.randn(64, 3, 7, 7, device=card, dtype=torch.bfloat16))



# (Nq, Nk) of one training microbatch (8 samples x 5 views) at batch 8
ATTN_TRAIN_SHAPES = [(105, 105), (21, 84), (21, 21)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("nq,nk", ATTN_TRAIN_SHAPES)
def test_attention_function_grads_match_plain(card, dtype, nq, nk):
    """At batch 8, through the design the rule picks: "query_tiles" for bf16
    at every shape and for fp32 at (105, 105)."""
    design = attention_design(dtype, 8, 8, nq, nk)
    assert design == "query_tiles" or (dtype == torch.float32 and nq == 21)
    design_before = fused_attention.design_launches[design]
    g = torch.Generator(card).manual_seed(nq * 1000 + nk)
    base = [torch.randn(8, n, 8, 128, generator=g, device=card).to(dtype) for n in (nq, nk, nk)]
    grad_out = torch.randn(8, 8, nq, 128, generator=g, device=card).to(dtype)
    grads = []
    for fn in (fused_attention, attention_plain):
        qkv = [t.clone().requires_grad_(True) for t in base]
        before = fused_attention.launches
        out = fn(*(t.transpose(1, 2) for t in qkv), 128 ** -0.5)
        if fn is fused_attention:
            assert "hmv_fused_attention" in type(out.grad_fn).__name__
            assert fused_attention.launches == before + 1
        out.backward(grad_out)
        grads.append([t.grad for t in qkv])
    assert fused_attention.design_launches[design] == design_before + 1
    for ours, ref in zip(*grads):
        assert ours.dtype == dtype and ours.device.type == "cuda"
        err = float((ours.float() - ref.float()).abs().max())
        assert err <= _tol(dtype, ref.float(), 1e-5), err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("n", [40, 2])
def test_stem_function_weight_grad_matches_plain(card, dtype, n):
    g = torch.Generator(card).manual_seed(n)
    x = torch.randn(n, 256, 256, 3, generator=g, device=card).to(dtype).permute(0, 3, 1, 2)
    base = (torch.randn(64, 3, 7, 7, generator=g, device=card) * 0.05).to(dtype)
    grad_out = torch.randn(n, 64, 128, 128, generator=g, device=card).to(dtype)
    grads = []
    for fn in (stem_conv_nchw, stem_conv_plain):
        weight = base.clone().requires_grad_(True)
        out = fn(x, weight)
        if fn is stem_conv_nchw:
            assert "hmv_stem_conv" in type(out.grad_fn).__name__
        out.backward(grad_out)
        grads.append(weight.grad)
    ours, ref = grads
    err = float((ours.float() - ref.float()).abs().max())
    assert err <= _tol(dtype, ref.float(), 1e-5 * float(ref.float().abs().max())), err


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_train_step_trains_through_both_kernels(card, compute_dtype):
    """A training step on the card launches K1 5 and K2 once per microbatch,
    and every parameter above a kernel gets a non-zero gradient: the stem's
    conv1.weight and each fusion block's to_q, to_k and to_v."""
    import dataclasses
    from pathlib import Path

    from handmvnet_tpu_torch.config import Config
    from handmvnet_tpu_torch.data.synthetic import synthetic_batch
    from handmvnet_tpu_torch.train_step import (
        accumulate_grads, batch_to_device, build_model, create_train_state)

    cfg = Config.from_yaml(Path(__file__).resolve().parents[1] / "configs" / "release"
                           / "HO3D_HandMvNet.yaml")
    cfg = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, selected_views=(0, 1, 2)),
        data=dataclasses.replace(cfg.data, image_size=64, heatmap_size=8),
        train=dataclasses.replace(cfg.train, compute_dtype=compute_dtype))
    state = create_train_state(build_model(cfg, "cuda", seed=0), cfg, steps_per_epoch=10)
    batch = batch_to_device(synthetic_batch(4, 3, 64, 8, seed=1), card)
    counts = (fused_attention.launches, stem_conv_nchw.launches)
    losses = accumulate_grads(state, cfg, batch, torch.Generator(card).manual_seed(0), 2)
    torch.cuda.synchronize()
    assert (fused_attention.launches - counts[0], stem_conv_nchw.launches - counts[1]) == (10, 2)
    assert torch.isfinite(losses["loss"]) and losses["loss"].dtype == torch.float32
    params = dict(state.model.named_parameters())
    watched = ["backbone.conv1.weight"] + [
        n for n in params if n.endswith(("to_q.weight", "to_k.weight", "to_v.weight"))]
    assert len(watched) == 1 + 15
    for name in watched:
        grad = params[name].grad
        assert grad is not None and grad.dtype == torch.float32, name
        assert float(grad.abs().max()) > 0, name


HR_CONFIG = "HO3D_HandMvNet_HR.yaml"


def _hr_config(compute_dtype: str = "float32"):
    import dataclasses
    from pathlib import Path

    from handmvnet_tpu_torch.config import Config

    cfg = Config.from_yaml(Path(__file__).resolve().parents[1] / "configs" / "release" / HR_CONFIG)
    return dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, compute_dtype=compute_dtype))


def test_hr_forward_kernel_path_matches_plain_path(card, monkeypatch):
    """The HRNet model's eval forward at b1 x v8 x 256^2 through K1 (5
    launches, no K2) against the same forward through the plain versions,
    with chip_smoke.py's tolerances."""
    from handmvnet_tpu_torch.eval_fps import protocol_step
    from handmvnet_tpu_torch.ops import attention as attention_ops

    step = protocol_step(_hr_config(), views=8, dtype=torch.float32, device="cuda",
                         with_vertices=False)
    counts = (fused_attention.launches, stem_conv_nchw.launches)
    with torch.inference_mode():
        out_k = step()
        torch.cuda.synchronize()
        assert (fused_attention.launches - counts[0], stem_conv_nchw.launches - counts[1]) == (5, 0)
        monkeypatch.setattr(attention_ops, "fused_attention", attention_plain)
        out_p = step()
    shapes = {"heatmap": (1, 8, 21, 32, 32), "joints_crop_img": (1, 8, 21, 2),
              "joints_cam": (1, 21, 3)}
    for key, tol in {"heatmap": 1e-4, "joints_crop_img": 5e-2, "joints_cam": 1e-4}.items():
        assert tuple(out_k[key].shape) == shapes[key] and torch.isfinite(out_k[key]).all(), key
        err = float((out_k[key] - out_p[key]).abs().max())
        assert err <= tol, (key, err)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_hr_train_step_trains_through_attention(card, compute_dtype):
    """A training step of the HRNet model on the card launches K1 5 times a
    microbatch and K2 never, and every parameter above K1 and the stem gets
    a non-zero gradient: backbone.conv1.weight, each to_q/to_k/to_v and each
    of the four SampleNets' convs. Every map is sampled at the heatmap's
    coordinates (the reference's cross-scale quirk), so the H/32 map covers
    only the heatmap's top-left; the head is set so that the joints land
    there: one tap that reads the padding at row and column 0, and minus the
    (non-negative) features everywhere else."""
    import dataclasses

    from handmvnet_tpu_torch.data.synthetic import synthetic_batch
    from handmvnet_tpu_torch.train_step import (
        accumulate_grads, batch_to_device, build_model, create_train_state)

    cfg = _hr_config(compute_dtype)
    cfg = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, selected_views=(0, 1, 2)),
        data=dataclasses.replace(cfg.data, image_size=64, heatmap_size=8))
    model = build_model(cfg, "cuda", seed=0)
    with torch.no_grad():
        model.pose_net.weight.zero_()
        model.pose_net.weight[:, :, 0, 0] = -1.0
        model.pose_net.bias.zero_()
    state = create_train_state(model, cfg, steps_per_epoch=10)
    batch = batch_to_device(synthetic_batch(4, 3, 64, 8, seed=1), card)
    counts = (fused_attention.launches, stem_conv_nchw.launches)
    losses = accumulate_grads(state, cfg, batch, torch.Generator(card).manual_seed(0), 2)
    torch.cuda.synchronize()
    assert (fused_attention.launches - counts[0], stem_conv_nchw.launches - counts[1]) == (10, 0)
    assert torch.isfinite(losses["loss"]) and losses["loss"].dtype == torch.float32
    params = dict(state.model.named_parameters())
    watched = ["backbone.conv1.weight"] + [
        n for n in params if n.endswith(("to_q.weight", "to_k.weight", "to_v.weight"))] + [
        f"sample_nets.{i}.conv.0.weight" for i in range(4)]
    assert len(watched) == 1 + 15 + 4
    for name in watched:
        grad = params[name].grad
        assert grad is not None and grad.dtype == torch.float32, name
        assert float(grad.abs().max()) > 0, name


# The mesh stage (SVD alignment, adaptive IK, MANO LBS) has no kernel of its
# own: these hold its PyTorch ops on the card against the same function on
# the CPU. Tolerance 2e-2 mm on vertices of |v| up to ~400 mm: the fp32 stage
# differs from float64 by up to ~5e-3 mm on such inputs, and the card's
# kernels round in other orders than the CPU's.
MESH_ATOL_MM = 2e-2


def _mesh_stages(card):
    from handmvnet_tpu_torch.eval_fps import build_mesh_stage

    return build_mesh_stage("cpu"), build_mesh_stage(str(card))


@pytest.mark.parametrize("batch", [1, 64])
def test_mesh_stage_on_card_matches_cpu(card, batch):
    from handmvnet_tpu_torch.data.synthetic import synthetic_hand_joints

    cpu, gpu = _mesh_stages(card)
    joints = synthetic_hand_joints(cpu.mano, batch, seed=batch)
    with torch.inference_mode():
        ref = cpu(joints)
        out = gpu(joints.to(card))
    assert out.device.type == "cuda" and out.shape == ref.shape == (batch, 778, 3)
    assert torch.isfinite(out).all()
    err = float((out.cpu() - ref).abs().max())
    assert err <= MESH_ATOL_MM, err


def test_mano_layer_buffers_move_to_card(card):
    from handmvnet_tpu_torch.models.joints_to_vertices import joints_to_vertices_fn
    from handmvnet_tpu_torch.models.mano import ManoLayer, synthetic_mano_model

    j2v = joints_to_vertices_fn(ManoLayer(synthetic_mano_model()).to(card))
    buffers = dict(j2v.named_buffers())
    assert {"template", "mano.v_template", "mano.posedirs", "mano.tip_ids"} <= set(buffers)
    assert all(b.device.type == "cuda" for b in buffers.values()), {
        k: b.device for k, b in buffers.items()}


def test_mesh_stage_does_no_host_work(card):
    """After warmup, one call on CUDA inputs runs under the sync debug mode's
    "error": a synchronising copy or a read to the host would raise."""
    from handmvnet_tpu_torch.data.synthetic import synthetic_hand_joints

    cpu, gpu = _mesh_stages(card)
    joints = synthetic_hand_joints(cpu.mano, 2, seed=0).to(card)
    with torch.inference_mode():
        gpu(joints)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = gpu(joints)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    assert out.device.type == "cuda"


# The data path on the card: nvJPEG (data/jpeg.py) against the shipped
# fixture's libjpeg pixels, make_device_prepare on the card against the CPU
# on the same decoded frames, and one eval batch through both kernels.

@pytest.mark.parametrize("batch", [1, 80], ids=["single", "eval-batch"])
def test_nvjpeg_decodes_the_fixture(card, batch):
    """Within data/jpeg.py's limits of cv2's pixels, at one frame and at the
    eval batch's 80 frames (where the library takes its other decode path)."""
    import numpy as np

    from handmvnet_tpu_torch.data import jpeg

    payload, ref = jpeg.jpeg_fixture()
    out = jpeg.decode_jpeg([payload] * batch, card)
    assert out.device.type == "cuda" and out.dtype == torch.uint8
    assert tuple(out.shape) == (batch, 480, 640, 3)
    assert bool((out == out[:1]).all())
    diff = np.abs(out[0].cpu().numpy().astype(np.int16) - ref)
    assert diff.max() <= jpeg.NVJPEG_MAX_ABS_DIFF and diff.mean() <= jpeg.NVJPEG_MEAN_ABS_DIFF


def test_nvjpeg_encode_round_trip(card):
    """The card's encoder (quality 95, 4:2:0) gives JPEGs that decode to the
    image: quality 95 quantises each DCT coefficient by 1-12 levels, so a
    smooth frame comes back within a few levels (a sanity bound, max 16,
    mean 2)."""
    import numpy as np

    from handmvnet_tpu_torch.data import jpeg

    _, ref = jpeg.jpeg_fixture()
    encoded = jpeg.encode_jpeg(torch.from_numpy(ref).to(card)[None])
    assert encoded[0][:2] == b"\xff\xd8"
    back = jpeg.decode_jpeg(encoded, card)[0].cpu().numpy().astype(np.int16)
    diff = np.abs(back - ref)
    assert diff.max() <= 16 and diff.mean() <= 2.0


def _shard_config(tmp_path, views: int, image: int):
    import dataclasses
    from pathlib import Path

    from handmvnet_tpu_torch.config import Config
    from handmvnet_tpu_torch.data.synthetic import write_synthetic_ho3d_shards

    write_synthetic_ho3d_shards(tmp_path, num_shards=9, samples_per_shard=1, num_views=views,
                                consistent_geometry=True, device="cuda")
    cfg = Config.from_yaml(Path(__file__).resolve().parents[1] / "configs" / "release"
                           / "HO3D_HandMvNet.yaml")
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, selected_views=tuple(range(views))),
        data=dataclasses.replace(cfg.data, dataset_dir=str(tmp_path), image_size=image,
                                 heatmap_size=image // 8, batch_size=2,
                                 selected_views=tuple(range(views)),
                                 split_size_overrides={"val": 2, "test": 2}))


def test_device_prepare_on_card_matches_cpu(card, tmp_path):
    """One val batch of card-written shards: make_device_prepare on the card
    (nvJPEG, then the crops and heatmaps there) against the same function on
    the CPU fed the card's decoded frames, so that only the preprocessing is
    compared (the decoders are held against each other above). rgb 1e-5,
    heatmap 1e-6, as tests/test_torch_data.py holds the CPU against JAX;
    labels exact."""
    from handmvnet_tpu_torch.data.ho3d import HO3DDataset
    from handmvnet_tpu_torch.data.jpeg import decode_jpeg
    from handmvnet_tpu_torch.data.loader import collate
    from handmvnet_tpu_torch.train import make_device_prepare

    cfg = _shard_config(tmp_path, views=3, image=256)
    batch = collate(list(HO3DDataset(cfg.data, "val", device="cuda")))
    flat = [p for views in batch["full_jpeg"] for p in views]
    frames = decode_jpeg(flat, card).cpu().numpy().reshape(2, 3, 480, 640, 3)
    cpu_batch = {k: v for k, v in batch.items() if k != "full_jpeg"}
    cpu_batch["full_rgb"] = frames
    got = make_device_prepare(cfg, card)(batch)
    ref = make_device_prepare(cfg, "cpu")(cpu_batch)
    assert set(got) == set(ref)
    for key, value in ref.items():
        assert got[key].device.type == "cuda" and got[key].dtype == value.dtype, key
        atol = {"rgb": 1e-5, "heatmap": 1e-6}.get(key, 0.0)
        err = float((got[key].cpu().double() - value.double()).abs().max())
        assert err <= atol, (key, err)
    assert float(ref["heatmap"].max()) > 0.1


def test_eval_batch_kernel_path_matches_plain_path(card, tmp_path, monkeypatch):
    """One prepared eval batch (2 samples x 2 views at 64^2) through the eval
    forward: K1 5 launches and K2 1, and the plain path within chip_smoke.py's
    serving tolerances."""
    from handmvnet_tpu_torch.eval_fps import build_model
    from handmvnet_tpu_torch.ops import attention as attention_ops
    from handmvnet_tpu_torch.ops import stem as stem_ops
    from handmvnet_tpu_torch.train import build_dataloaders
    from handmvnet_tpu_torch.train_step import eval_step

    cfg = _shard_config(tmp_path, views=2, image=64)
    model = build_model(cfg, views=2, image_size=64, device="cuda")
    val, _ = build_dataloaders(cfg, card)
    batch = next(iter(val))
    counts = (fused_attention.launches, stem_conv_nchw.launches)
    out_k = eval_step(model, batch)
    torch.cuda.synchronize()
    assert (fused_attention.launches - counts[0], stem_conv_nchw.launches - counts[1]) == (5, 1)
    monkeypatch.setattr(attention_ops, "fused_attention", attention_plain)
    monkeypatch.setattr(stem_ops, "stem_conv_nchw", stem_conv_plain)
    out_p = eval_step(model, batch)
    for key, tol in {"heatmap": 1e-4, "joints_crop_img": 5e-2, "joints_cam": 1e-4}.items():
        assert out_k[key].device.type == "cuda" and torch.isfinite(out_k[key]).all(), key
        err = float((out_k[key] - out_p[key]).abs().max())
        assert err <= tol, (key, err)


# The train split's data path on the card: augmentation against the CPU at
# the same draws and without a host sync, and the loader's preparer stage
# (its own CUDA stream) against preparation on the consumer's thread.

def test_augmentation_on_card_matches_cpu_without_syncing(card):
    """40 crops of 256^2 at magnifications 0.5-3.5 and fixed draws (drawn on
    the CPU, then moved): within 2e-4 of the CPU, chip_smoke.py's AUG_ATOL
    (the box blur's cumsum rounding 4 S eps / w at S = 256, w >= 2, tripled
    by the 2x sharpening), but for posterize flips of 4/255 (to that limit)
    on at most 1e-4 of the elements (tests/test_torch_augment.py's chain
    rule); then augment_batch from a generator on the card under the sync
    debug mode "error"."""
    from handmvnet_tpu_torch.data import augment

    gen = torch.Generator().manual_seed(0)
    images = torch.rand(40, 256, 256, 3, generator=gen)
    scales = torch.rand(40, generator=gen) * 3.0 + 0.5
    draws = augment.draw_augmentation(40, gen, "cpu")
    ref = augment.apply_augmentation(images, draws, scales)
    got = augment.apply_augmentation(images.to(card), {k: v.to(card) for k, v in draws.items()},
                                     scales.to(card))
    diff = (got.cpu() - ref).abs()
    flips = diff > 2e-4
    assert float(diff[~flips].max()) <= 2e-4
    assert bool(((diff[flips] - 4.0 / 255.0).abs() <= 2e-4).all())
    assert float(flips.float().mean()) <= 1e-4
    card_gen = torch.Generator(card).manual_seed(1)
    x = images.to(card)
    scales = scales.to(card)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = augment.augment_batch(x, card_gen, scales)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert out.device.type == "cuda" and out.shape == x.shape


def test_train_loader_preparer_stage_on_card(card, tmp_path):
    """The train loader on card-written shards, augmentation on: its batches
    from the preparer stage (a CUDA stream of its own) equal, bit for bit,
    those prepared on the consumer's thread and stream."""
    import dataclasses

    from handmvnet_tpu_torch.train import build_dataloaders

    cfg = _shard_config(tmp_path, views=2, image=64)
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, split_size_overrides={"train+val": 8, "val": 2}))
    runs = []
    for prefetch in (True, False):
        (loader,) = build_dataloaders(cfg, card, ("train",))
        loader.device_prefetch = prefetch
        runs.append([{k: v.clone() for k, v in b.items()} for b in loader])
    assert len(runs[0]) == 4
    for got, want in zip(*runs):
        assert got["rgb"].device.type == "cuda"
        for key, value in want.items():
            assert torch.equal(got[key], value), key


@pytest.mark.parametrize("denom", [2, 4, 5, 8])
def test_downscale_on_card_matches_cpu(card, denom):
    """data/jpeg.py's downscale_frames (the downscaled decode) on the card
    bitwise equal to the CPU on the same frames (integer ops), and nvJPEG's
    fixture downscaled within nvJPEG's limits of cv2's pixels downscaled."""
    import numpy as np

    from handmvnet_tpu_torch.data import jpeg

    payload, ref = jpeg.jpeg_fixture()
    frames = jpeg.decode_jpeg([payload] * 4, card)
    noise = torch.randint(0, 256, (3, 480, 640, 3), dtype=torch.uint8,
                          generator=torch.Generator().manual_seed(denom))
    for x in (frames, noise.to(card)):
        assert torch.equal(jpeg.downscale_frames(x, denom).cpu(),
                           jpeg.downscale_frames(x.cpu(), denom))
    want = jpeg.downscale_frames(torch.from_numpy(ref)[None], denom).numpy().astype(np.int16)
    diff = np.abs(jpeg.downscale_frames(frames, denom)[:1].cpu().numpy().astype(np.int16) - want)
    assert diff.max() <= jpeg.NVJPEG_MAX_ABS_DIFF and diff.mean() <= jpeg.NVJPEG_MEAN_ABS_DIFF


def test_decode_cache_on_card_stores_nvjpegs_frames(card, tmp_path):
    """cache_decoded on the card at decode_scale_denom 2: the store holds
    nvJPEG's decode, downscaled, of each batch of the reader (bitwise), a
    second epoch makes no nvJPEG call, and the store is not the CPU's."""
    import dataclasses

    import numpy as np

    from handmvnet_tpu_torch.data import jpeg
    from handmvnet_tpu_torch.data.ho3d import HO3DDataset

    cfg = _shard_config(tmp_path / "data", views=2, image=64)
    data = dataclasses.replace(cfg.data, decode_scale_denom=2)
    cached = dataclasses.replace(data, cache_decoded=True, cache_dir=str(tmp_path / "cache"))
    ds = HO3DDataset(cached, "val", device=card)
    first = list(ds)
    calls = jpeg.decode_jpeg.calls
    second = list(ds)
    assert jpeg.decode_jpeg.calls == calls
    assert [s["mv_sample_id"] for s in first] == [s["mv_sample_id"] for s in second]
    plain = list(HO3DDataset(data, "val", device=card))
    for i in range(0, len(plain), data.batch_size):
        chunk = plain[i:i + data.batch_size]
        frames = jpeg.downscale_frames(
            jpeg.decode_jpeg([p for s in chunk for p in s["full_jpeg"]], card), 2).cpu().numpy()
        for s, f in zip(first[i:i + data.batch_size], frames.reshape(len(chunk), 2, 240, 320, 3)):
            np.testing.assert_array_equal(s["full_rgb"], f)
    assert ds._cache().identity["reader"] == "nvjpeg"
    assert ds._cache().dir != HO3DDataset(cached, "val", device="cpu")._cache().dir
