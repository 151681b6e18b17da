"""The port's loading of the JAX package's committed checkpoint, and the isolation of
the port from JAX."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from palettenerf_tpu.models import nerf as jnerf
from palettenerf_torch.models import nerf as tnerf
from palettenerf_torch.train import checkpoint as tckpt
from torch_support import CPU_THREADS

torch.set_num_threads(CPU_THREADS)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEPLOY = os.path.join(REPO, "deploy", "proc_toys", "palette_ep0080.ckpt")


@pytest.fixture(scope="module")
def deploy_tree():
    return tckpt.load_reference_checkpoint(DEPLOY)


def test_deploy_checkpoint_density_matches_jax(deploy_tree):
    params = deploy_tree["params"]
    # the MLPs were saved as numpy object arrays (one {"w": ...} dict per layer)
    assert params["sigma_net"].dtype == object
    tparams = tckpt.params_from_jax(params)
    assert tparams["encoder"].shape == (6_119_864, 2) and tparams["encoder"].dtype == torch.float32
    assert [tuple(w.shape) for w in tparams["sigma_net"]] == [(32, 64), (64, 16)]

    jspec = jnerf.NeRFSpec.build(bound=1.0)
    tspec = tnerf.NeRFSpec.build(bound=1.0)
    x = np.random.default_rng(0).uniform(-1, 1, (1000, 3)).astype(np.float32)
    jparams = {"encoder": jnp.asarray(tparams["encoder"].numpy()),
               "sigma_net": [{"w": jnp.asarray(w.numpy())} for w in tparams["sigma_net"]]}
    ref = jnerf.nerf_density(jparams, jspec, jnp.asarray(x))
    got = tnerf.nerf_density(tparams, tspec, torch.from_numpy(x))
    assert float(got["sigma"].max()) > 10.0  # a trained field: real density somewhere
    np.testing.assert_allclose(got["sigma"].detach().numpy(), np.asarray(ref["sigma"]),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got["geo_feat"].detach().numpy(), np.asarray(ref["geo_feat"]),
                               rtol=1e-4, atol=1e-4)


def test_bf16_leaf_converts_bit_exact(deploy_tree):
    """The loader reads the bf16 tables as their 16-bit words; as torch.bfloat16 they
    equal an ml_dtypes load of the same file bit for bit."""
    import pickle

    with open(DEPLOY, "rb") as f:
        ref = pickle.load(f)["params"]  # ml_dtypes is installed here
    for name in ("encoder", "encoder_palette", "encoder_clip", "hist_weights"):
        words = deploy_tree["params"][name]
        assert words.dtype == np.uint16 and ref[name].dtype.name == "bfloat16"
        t = tckpt._leaf_to_tensor(words, dtype=None)
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                      np.asarray(ref[name]).view(np.int16))
    np.testing.assert_array_equal(tckpt._leaf_to_tensor(words[:4], dtype=None).float().numpy(),
                                  np.asarray(ref["hist_weights"][:4], np.float32))


def test_missing_ml_dtypes_gives_clear_error(tmp_path):
    """Without ml_dtypes the deploy checkpoint still loads, its bf16 tables equal to an
    ml_dtypes load bit for bit; a leaf of another ml_dtypes type fails with a clear
    error instead of a bare ModuleNotFoundError."""
    import pickle

    import ml_dtypes

    with open(DEPLOY, "rb") as f:
        ref = pickle.load(f)["params"]
    ref_bits = str(int(np.asarray(ref["encoder"]).view(np.uint16).astype(np.int64).sum()))
    odd = tmp_path / "fp8.ckpt"
    with open(odd, "wb") as f:
        pickle.dump({"params": {"x": np.zeros(3, ml_dtypes.float8_e4m3fn)}}, f)
    code = (
        "import sys; sys.modules['ml_dtypes'] = None\n"
        "import numpy as np\n"
        "from palettenerf_torch.train.checkpoint import load_reference_checkpoint, "
        "palette_params_from_jax\n"
        f"tree = load_reference_checkpoint({DEPLOY!r})['params']\n"
        "print('BITS', int(tree['encoder'].astype(np.int64).sum()))\n"
        "p = palette_params_from_jax(tree)\n"
        "print('LOADED', p['encoder'].shape, p['basis_color'].shape)\n"
        "try:\n"
        f"    load_reference_checkpoint({str(odd)!r})\n"
        "except Exception as e:\n"
        "    print('ERR', type(e).__name__, e)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=REPO, timeout=120)
    assert out.returncode == 0, out.stderr
    assert f"BITS {ref_bits}" in out.stdout, out.stdout
    assert "LOADED torch.Size([6119864, 2]) torch.Size([5, 3])" in out.stdout
    assert "ERR UnpicklingError" in out.stdout and "float8_e4m3fn" in out.stdout


def test_port_imports_nothing_of_jax():
    """Import every module of palettenerf_torch and chip_smoke in a fresh interpreter:
    jax, optax, palettenerf_tpu, cv2, ml_dtypes, sklearn and PIL stay out of sys.modules,
    and the modules of the palette stages, of the editing path and the leaf ops, the
    rLPIPS / LPIPS parts of the metrics, ray data-parallel training, the native
    extraction kernels, the profiling utilities, the image input (the JPEG decoder's
    binding in ``native``, ``data.image``, ``data.png``), the serve-vs-ground-truth
    check (``serve_vs_gt``) and the trainers' draw source (``train.draws``) are among those
    imported."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import palettenerf_torch\n"
        "for m in pkgutil.walk_packages(palettenerf_torch.__path__, 'palettenerf_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [m for m in ('jax', 'jaxlib', 'optax', 'palettenerf_tpu', 'cv2', 'ml_dtypes',\n"
        "                   'sklearn', 'PIL') if m in sys.modules]\n"
        "new = ['main_palette', 'train.palette_trainer', 'data.palette_provider',\n"
        "       'extraction.extract', 'extraction.histogram', 'extraction.geometry',\n"
        "       'extraction.hull', 'extraction.tan18', 'gui', 'gui.camera', 'gui.headless',\n"
        "       'gui.dpg_gui', 'utils.mcubes', 'ops.freq', 'ops.encoding', 'ops.losses',\n"
        "       'ops.morton', 'ops.sampling', 'train.metrics', 'parallel', 'parallel.ranks',\n"
        "       'native', 'utils.profiling', 'data.image', 'data.png', 'serve_vs_gt',\n"
        "       'train.draws']\n"
        "bad += [m for m in new if 'palettenerf_torch.' + m not in sys.modules]\n"
        "metrics = sys.modules['palettenerf_torch.train.metrics']\n"
        "bad += [a for a in ('make_rlpips_kernels', 'rlpips_distance', 'RLPIPSMeter',\n"
        "                    'LPIPSMeter') if not hasattr(metrics, a)]\n"
        "n = len([m for m in sys.modules if m.startswith('palettenerf_torch.')])\n"
        "print('BAD', bad, 'N', n)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=REPO, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "BAD [] " in out.stdout, out.stdout
    assert int(out.stdout.split("N")[-1]) >= 50
