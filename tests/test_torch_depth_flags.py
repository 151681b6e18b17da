"""The argument lists of ``chip_smoke.py --depth-only`` against the shell recipes they
run: ``scripts/run_blender.sh`` with ``scripts/configs_proc/proc_toys.sh``,
``scripts/run_mip360.sh`` with ``scripts/configs_mip360/bonsai.sh`` and
``scripts/run_llff.sh`` with ``scripts/configs_llff/fern.sh``, parsed as text. Each mode's
list is the recipe's command line with only ``--iters`` (the config's ``iters``),
``EXTRA_FLAGS``, the workspace (the config's ``name``) and, for the mip360 and LLFF recipes
on the committed fixtures, the scene (``data_dir``) set; the chain's extraction adds the
README's ``--extract_downscale 2`` (README.md:443).
"""

import os
import re
import shlex

import pytest

import chip_smoke as cs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _config(path: str, **override) -> dict:
    """``name=value`` lines of a config script, ``${var}`` expanded, with ``override``."""
    env = {}
    with open(os.path.join(REPO, path)) as f:
        for line in f:
            m = re.match(r"^(\w+)=(.*)$", line.strip())
            if m:
                env[m.group(1)] = _expand(shlex.split(m.group(2))[0] if m.group(2) else "",
                                          env)
            if m and m.group(1) in override:
                env[m.group(1)] = override[m.group(1)]
    if "nerf_model" in env:  # defined from name: follow the workspace
        env["nerf_model"] = f"./results/{env['name']}"
    return env


def _expand(text: str, env: dict) -> str:
    return re.sub(r"\$\{(\w+)\}|\$(\w+)", lambda m: env.get(m.group(1) or m.group(2), ""),
                  text)


def _recipe(script: str, model: str, env: dict) -> list:
    """The argument list the branch ``model`` of ``script`` passes to its entry point."""
    with open(os.path.join(REPO, script)) as f:
        text = f.read()
    branch = re.search(r"\[\[ \$model == '" + model + r"' \]\]; then\n(.*?)\n(?:elif|else)",
                       text, re.S).group(1)
    tokens = shlex.split(_expand(branch.replace("\\\n", " "), env))
    assert tokens[0] == "python" and tokens[1].startswith("main_")
    return tokens[2:]


BLENDER = ("scripts/run_blender.sh", "scripts/configs_proc/proc_toys.sh")
MIP360 = ("scripts/run_mip360.sh", "scripts/configs_mip360/bonsai.sh")
FERN = ("scripts/run_llff.sh", "scripts/configs_llff/fern.sh")
LLFF = dict(data_dir=cs.LLFF_DATA)
FF = dict(data_dir=cs.FF_DATA, name=cs.LLFF_WS)
CASES = {
    # mode: (recipe, -m, what the config sets, EXTRA_FLAGS, the mode's list, additions)
    "chain-nerf": (BLENDER, "nerf", dict(name=cs.CHAIN_WS), "--fast_grad",
                   cs.CHAIN_NERF_ARGS, []),
    "chain-extract": (BLENDER, "extract", dict(name=cs.CHAIN_WS), "",
                      cs.CHAIN_EXTRACT_ARGS, ["--extract_downscale", "2"]),
    "chain-palette": (BLENDER, "palette", dict(name=cs.CHAIN_WS), "--fast_grad",
                      cs.CHAIN_PALETTE_ARGS, []),
    "stage1-O": (BLENDER, "nerf", dict(name="depth_stage1_O"), "", cs.STAGE1_RUNS["O"], []),
    "stage1-O2": (BLENDER, "nerf", dict(name="depth_stage1_O2"), "-O2",
                  cs.STAGE1_RUNS["O2"], []),
    "mip360-nerf": (MIP360, "nerf", dict(LLFF, name=cs.MIP360_WS, iters=str(cs.MIP360_ITERS)),
                    "", cs.mip360_nerf_args(cs.LLFF_DATA, cs.MIP360_WS, cs.MIP360_ITERS), []),
    "mip360-extract": (MIP360, "extract", dict(LLFF, name=cs.MIP360_WS), "",
                       cs.mip360_extract_args(cs.LLFF_DATA, f"./results/{cs.MIP360_WS}"), []),
    "mip360-palette": (MIP360, "palette",
                       dict(LLFF, name=cs.MIP360_WS, iters=str(cs.MIP360_ITERS)), "",
                       cs.mip360_palette_args(cs.LLFF_DATA, f"./results/{cs.MIP360_WS}",
                                              cs.MIP360_ITERS), []),
    "llff-nerf": (FERN, "nerf", FF, "", cs.llff_nerf_args(cs.FF_DATA, cs.LLFF_WS, cs.LLFF_ITERS),
                  []),
    "llff-extract": (FERN, "extract", FF, "",
                     cs.llff_extract_args(cs.FF_DATA, f"./results/{cs.LLFF_WS}"), []),
    "llff-palette": (FERN, "palette", FF, "",
                     cs.llff_palette_args(cs.FF_DATA, f"./results/{cs.LLFF_WS}", cs.LLFF_ITERS),
                     []),
    "real-scene-nerf": (MIP360, "nerf", dict(data_dir=cs.LLFF_SCENE, name="chip_smoke_real",
                                             iters="300"), "", cs.REAL_NERF_ARGS, []),
    "real-scene-palette": (MIP360, "palette",
                           dict(data_dir=cs.LLFF_SCENE, name="chip_smoke_real", iters="300"),
                           "", cs.REAL_PALETTE_ARGS, []),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_depth_mode_args_are_the_recipe(case):
    (script, config), model, sets, extra, got, added = CASES[case]
    env = _config(config, **sets)
    env.update(test_mode="", EXTRA_FLAGS=extra)
    want = _recipe(script, model, env) + added
    if "nerf_model" in env and model != "nerf":  # the mode names the stage-1 workspace
        assert got[1] in (env["nerf_model"], env["nerf_model"][2:]), got[1]
        got = [got[0], env["nerf_model"]] + got[2:]
    assert got == want


def test_proc_toys_recipe_depth():
    """The chain and stage1 modes run the config's own iters (8000), with -O and
    --dt_gamma 0 as the recipe passes them (the default run's MAIN_ARGS lack the latter)."""
    assert _config(BLENDER[1])["iters"] == str(cs.DEPTH_ITERS) == "8000"
    for args in (cs.CHAIN_NERF_ARGS, *cs.STAGE1_RUNS.values()):
        assert args[args.index("--iters") + 1] == "8000"
        assert args[args.index("--dt_gamma") + 1] == "0"
    assert "--dt_gamma" not in cs.MAIN_ARGS


def test_llff_recipe_depth_and_offsets():
    """The llff mode runs fern's own iters (10,000); its stage 1 and palette stage pass
    fern's ``--offset 0 0 1.5``, and its extraction none, as ``run_llff.sh``'s extract
    block does."""
    assert _config(FERN[1])["iters"] == str(cs.LLFF_ITERS) == "10000"
    nerf = cs.llff_nerf_args(cs.FF_DATA, cs.LLFF_WS, cs.LLFF_ITERS)
    palette = cs.llff_palette_args(cs.FF_DATA, f"./results/{cs.LLFF_WS}", cs.LLFF_ITERS)
    for args in (nerf, palette):
        i = args.index("--offset")
        assert args[i + 1:i + 4] == ["0", "0", "1.5"]
    assert "--offset" not in cs.llff_extract_args(cs.FF_DATA, f"./results/{cs.LLFF_WS}")
    assert palette[palette.index("--datatype") + 1] == "llff"


def test_bg_mode_is_the_default_runs_bg_patch_flags():
    """The bg mode is BG_PATCH_ARGS with --iters 8000 and its own workspace."""
    want = [a for a in cs.BG_PATCH_ARGS]
    want[want.index("--iters") + 1] = "8000"
    want[want.index("--workspace") + 1] = "depth_bg"
    assert cs.BG_DEPTH_ARGS == want


def test_depth_modes_parse():
    for mode in ("chain", "mip360", "mip360-explore", "stage1", "bg", "llff"):
        assert cs.parse_mode(["--depth-only", mode]) == ("depth", mode)
    assert cs.parse_mode(["--depth-only", "bogus"]) is None
    assert cs.parse_mode(["--real-scene-only", "--trace-memory"]) == ("real", True)
    assert cs.parse_mode([]) == ("all", None)
