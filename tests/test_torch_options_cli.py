"""The CLIs of the port on the CPU with the options ported with the background net: the
stage-1 CLI with ``--bg_radius``, ``--patch_size 4 --lambda_lpips 0.1`` and ``--color_space
linear``, then the palette CLI's training (patches, which take no LPIPS term in that stage)
and ``--test`` on that workspace. The parity of each piece against the JAX package is in
``tests/test_torch_background.py`` and ``tests/test_torch_rlpips.py``."""

import numpy as np
import torch

from palettenerf_torch import main_nerf, main_palette
from palettenerf_torch.train import checkpoint as tckpt
from synthetic import make_sphere_dataset
from torch_support import CPU_THREADS

torch.set_num_threads(CPU_THREADS)
RADIUS = 4.0


def test_clis_run_the_ported_options_on_cpu(tmp_path, monkeypatch):
    """``main_nerf`` with the background net, the patch loss and the linear colour space,
    then ``main_palette`` training (patches, no LPIPS term) and ``--test`` on that
    workspace: both CLIs run them end to end, the bg net warm-started from stage 1."""
    monkeypatch.chdir(tmp_path)
    scene = make_sphere_dataset(str(tmp_path / "scene"), n_train=4, n_val=1, n_test=1,
                                H=24, W=24)
    common = ["-O", "--bound", "1", "--scale", "0.7", "--dt_gamma", "0", "--min_near", "0.05",
              "--num_rays", "256", "--max_steps", "64", "--train_samples_per_ray", "16",
              "--infer_samples_per_ray", "32", "--log2_hashmap_size", "10", "--grid_levels",
              "4", "--bg_radius", str(RADIUS), "--color_space", "linear"]
    nerf = main_nerf.main([scene] + common + ["--iters", "16", "--eval_interval", "100",
                                              "--patch_size", "4", "--lambda_lpips", "0.1"],
                          device="cpu", mesh_resolution=16)
    assert nerf.global_step == 16 and nerf.host_sampled() and "bg_net" in nerf.params
    assert [m.name for m in nerf.metrics] == ["PSNR", "LPIPS (alex)", "rLPIPS"]
    assert np.isfinite(nerf.stats["loss"]).all()
    pal = main_palette.main([scene, "results/workspace"] + common + [
        "--iters", "8", "--eval_interval", "2", "--patch_size", "4"], device="cpu")
    assert pal.global_step == 8 and pal.palette_spec.color_space == "linear"
    assert np.isfinite(pal.stats["loss"]).all() and pal.stats["results"]
    stage1 = tckpt.load_checkpoint(tckpt.latest_checkpoint(
        "results/workspace/version_1/checkpoints", "ngp"))["params"]
    log = open(pal.log_path).read()
    assert "warm-started 9 tensors" in log  # encoder, 2 + 3 MLP layers, encoder_bg, 2 layers
    assert not torch.equal(pal.params["encoder_bg"].detach(), stage1["encoder_bg"])  # trained
    test = main_palette.main([scene, "results/workspace"] + common + ["--test"], device="cpu")
    assert test.epoch == pal.epoch and len(test.metrics) == 6
    assert torch.equal(test.params["encoder_bg"], pal.params["encoder_bg"].detach())
