"""Guards of the PyTorch port: import boundary, device rule, kernel wrapper
dispatch and strict weight loading. CPU only; no JAX needed."""
import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mrfa_tpu_torch.animate import Animator
from mrfa_tpu_torch.models.mrfa import MRFA
from mrfa_tpu_torch.ops.corr_lookup import (
    CorrLookup,
    CorrLookupBwd,
    corr_lookup,
    corr_lookup_bwd_plain,
    corr_lookup_plain,
)
from mrfa_tpu_torch.ops.splat import Splat, splat_plain
from mrfa_tpu_torch.train.trainer import Trainer
from mrfa_tpu_torch.utils.convert import load_jax_variables
from tests.torch_parity import mtia_cfg, train_cfg

REPO = Path(__file__).resolve().parents[1]
PACKAGE = REPO / "mrfa_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "mrfa_tpu")
# host packages the GPU machine lacks: imported only inside the functions
# that need them (image and video files), never when a module is imported
HOST_ONLY = ("imageio", "matplotlib", "pandas", "cv2", "orbax")


def test_importing_the_port_loads_no_jax_and_no_mrfa_tpu():
    code = f"""
import importlib, pkgutil, sys
sys.path.insert(0, {str(REPO)!r})
before = set(sys.modules)
import mrfa_tpu_torch
for info in pkgutil.walk_packages(mrfa_tpu_torch.__path__, "mrfa_tpu_torch."):
    importlib.import_module(info.name)
new = set(sys.modules) - before
bad = sorted(m for m in new if m.split(".")[0] in {FORBIDDEN!r})
assert not bad, bad
assert "mrfa_tpu_torch.animate" in sys.modules
print("ok")
"""
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=300
    )
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr[-2000:]


@pytest.mark.parametrize(
    "module", ["mrfa_tpu_torch.serving", "mrfa_tpu_torch.models.kp_detector",
               "mrfa_tpu_torch.weights", "mrfa_tpu_torch.native", "mrfa_tpu_torch.utils.profiling",
               "mrfa_tpu_torch.cli.demo", "mrfa_tpu_torch.cli.convert",
               "mrfa_tpu_torch.cli.convert_backbones", "mrfa_tpu_torch.data.dataset",
               "mrfa_tpu_torch.parallel.mesh"],
)
def test_each_module_alone_loads_no_jax_and_no_mrfa_tpu(module):
    code = f"""
import importlib, sys
sys.path.insert(0, {str(REPO)!r})
before = set(sys.modules)
importlib.import_module({module!r})
bad = sorted(m for m in set(sys.modules) - before if m.split(".")[0] in {FORBIDDEN!r})
assert not bad, bad
print("ok")
"""
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=300
    )
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr[-2000:]


@pytest.mark.parametrize(
    "path", sorted(PACKAGE.rglob("*.py")) + [REPO / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(REPO)),
)
def test_source_imports_no_jax_and_no_mrfa_tpu(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path}:{node.lineno} imports {name}"


def test_importing_the_port_loads_no_host_only_package():
    code = f"""
import importlib, pkgutil, sys
sys.path.insert(0, {str(REPO)!r})
before = set(sys.modules)
import mrfa_tpu_torch
for info in pkgutil.walk_packages(mrfa_tpu_torch.__path__, "mrfa_tpu_torch."):
    importlib.import_module(info.name)
bad = sorted(m for m in set(sys.modules) - before if m.split(".")[0] in {HOST_ONLY!r})
assert not bad, bad
assert "mrfa_tpu_torch.cli.run" in sys.modules and "mrfa_tpu_torch.evals" in sys.modules
print("ok")
"""
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=300
    )
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr[-2000:]


@pytest.mark.parametrize(
    "path", sorted(PACKAGE.rglob("*.py")) + [REPO / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(REPO)),
)
def test_source_imports_host_only_packages_inside_functions_only(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in tree.body:
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in HOST_ONLY, f"{path}:{node.lineno} imports {name}"


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_cuda_unless_cpu_is_asked(no_cuda):
    cfg = mtia_cfg(64, blocks=3, depth=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MRFA(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MRFA(cfg, device="cuda")
    model = MRFA(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Animator(model, model.state_dict())
    assert Animator(model, model.state_dict(), device="cpu").device.type == "cpu"


def test_server_raises_without_cuda_unless_cpu_is_asked(no_cuda):
    from mrfa_tpu_torch.serving import AnimationServer

    model = MRFA(mtia_cfg(64, blocks=3, depth=1), device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AnimationServer(model, model.state_dict())
    assert AnimationServer(model, model.state_dict(), device="cpu").device.type == "cpu"


def test_trainer_raises_without_cuda_unless_cpu_is_asked(no_cuda):
    cfg = train_cfg(64, blocks=3, depth=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(cfg)
    with pytest.warns(UserWarning, match="RANDOMLY INITIALIZED VGG19"):
        assert Trainer(cfg, device="cpu").device.type == "cpu"


def test_bf16_trainer_raises_without_cuda_unless_cpu_is_asked(no_cuda):
    cfg = train_cfg(64, blocks=3, depth=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(cfg, compute_dtype=torch.bfloat16)
    with pytest.warns(UserWarning, match="RANDOMLY INITIALIZED VGG19"):
        trainer = Trainer(cfg, device="cpu", compute_dtype=torch.bfloat16)
    assert trainer.device.type == "cpu" and trainer.model.compute_dtype == torch.bfloat16


def test_demo_and_convert_raise_without_cuda_unless_cpu_is_asked(no_cuda, tmp_path):
    from mrfa_tpu_torch.cli import convert, demo
    from mrfa_tpu_torch.utils.video import save_image
    from tests.torch_parity import write_cli_inputs

    config, pth, _ = write_cli_inputs(str(tmp_path))
    source = str(tmp_path / "driving" / "source.png")
    (tmp_path / "driving").mkdir()
    save_image(source, np.zeros((64, 64, 3), np.uint8))
    demo_args = [f"--config={config}", f"--checkpoint={pth}", f"--source_image={source}",
                 f"--driving_video={tmp_path / 'driving'}", "--img_shape=64,64",
                 f"--result_video={tmp_path / 'out.mp4'}"]
    convert_args = [f"--config={config}", f"--checkpoint={pth}", f"--out={tmp_path / 'ckpt'}"]
    for main, args in ((demo.main, demo_args), (convert.main, convert_args)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main(args)
    assert convert.main(convert_args + ["--device=cpu"]) == ([], [])
    frames, _ = demo.main(demo_args + ["--device=cpu"])
    assert len(frames) == 1 and frames[0].shape == (64, 64, 3)


def test_loop_evals_and_cli_raise_without_cuda_unless_cpu_is_asked(no_cuda, tmp_path):
    from mrfa_tpu_torch import evals
    from mrfa_tpu_torch.cli.run import main
    from mrfa_tpu_torch.train.loop import train

    cfg = train_cfg(64, blocks=3, depth=1)
    cfg["train_params"].update(num_epochs=0, batch_size=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train(cfg, None, str(tmp_path / "log"), [])
    model = MRFA(cfg, device="cpu")
    for run in (evals.reconstruction, evals.animate):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            run(cfg, model, str(tmp_path / "eval"), [])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--config", str(REPO / "config" / "vox1.yaml"), "--mode", "train"])
    with pytest.warns(UserWarning, match="RANDOMLY INITIALIZED VGG19"):
        assert train(cfg, None, str(tmp_path / "log"), [], device="cpu").device.type == "cpu"


def _maps(bq=8, size=16, dtype=torch.float32, seed=0):
    g = torch.Generator().manual_seed(seed)
    c0 = torch.randn(bq, size, size, generator=g).to(dtype)
    c1 = torch.randn(bq, size // 2, size // 2, generator=g).to(dtype)
    coords = torch.rand(bq, 2, generator=g) * (size + 8) - 4
    return c0, c1, coords


def test_lookup_wrapper_takes_plain_path_on_cpu_and_counts_no_launch():
    wrapper = CorrLookup()
    shared = corr_lookup.launches
    for dtype in (torch.float32, torch.bfloat16):
        c0, c1, coords = _maps(dtype=dtype)
        out = wrapper(c0, c1, coords)
        assert out.shape == (8, 98) and out.dtype == dtype
        torch.testing.assert_close(out, corr_lookup_plain(c0, c1, coords), rtol=0, atol=0)
    assert wrapper.launches == 0 and corr_lookup.launches == shared
    assert wrapper.library._lib is None  # nothing was built or loaded


def _splat_args(seed=0, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    b, n, c, h, w = 2, 30, 5, 6, 7
    grad = torch.randn(b, n, c, generator=g).to(dtype)
    y0 = torch.randint(-2, h + 2, (b, n), generator=g, dtype=torch.int32)
    x0 = torch.randint(-2, w + 2, (b, n), generator=g, dtype=torch.int32)
    ws = [torch.rand(b, n, generator=g) for _ in range(4)]
    return (grad, y0, ws[0], ws[1], x0, ws[2], ws[3], h, w)


def test_backward_wrappers_take_plain_paths_on_cpu_and_count_no_launch():
    lookup_bwd, spl = CorrLookupBwd(), Splat()
    for dtype in (torch.float32, torch.bfloat16):
        c0, c1, coords = _maps(dtype=dtype)
        g = torch.randn(8, 98)
        for got, want in zip(lookup_bwd(c0, c1, coords, g),
                             corr_lookup_bwd_plain(c0, c1, coords, g)):
            torch.testing.assert_close(got, want, rtol=0, atol=0)
        args = _splat_args(dtype=dtype)
        out = spl(*args)
        assert out.shape == (2, 6, 7, 5) and out.dtype == torch.float32
        torch.testing.assert_close(out, splat_plain(*args), rtol=0, atol=0)
    assert lookup_bwd.launches == 0 and spl.launches == 0
    assert lookup_bwd.library._lib is None and spl.library._lib is None


def test_kernel_paths_raise_off_the_cpu_and_without_a_build(monkeypatch):
    """No fallback: a tensor on another device raises, and so does a kernel
    that cannot be built (this host has no nvcc)."""
    c0, c1, coords = (t.to("meta") for t in _maps())
    with pytest.raises(ValueError, match="cuda or cpu"):
        CorrLookupBwd()(c0, c1, coords, torch.empty(8, 98, device="meta"))
    with pytest.raises(ValueError, match="cuda or cpu"):
        Splat()(*(a.to("meta") if torch.is_tensor(a) else a for a in _splat_args()))
    monkeypatch.setenv("PATH", "")
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr("os.access", lambda *a: False)
    for wrapper in (CorrLookup(), CorrLookupBwd(), Splat()):
        with pytest.raises(RuntimeError, match="nvcc not found"):
            wrapper.library.load()


@pytest.mark.parametrize("case", ["g_shape", "g_dtype", "index_dtype", "weight_shape",
                                  "contiguity"])
def test_splat_wrapper_rejects_bad_inputs(case):
    args = list(_splat_args())
    if case == "g_shape":
        args[0] = args[0][0]
    elif case == "g_dtype":
        args[0] = args[0].half()
    elif case == "index_dtype":
        args[1] = args[1].long()
    elif case == "weight_shape":
        args[2] = args[2][:, :-1]
    elif case == "contiguity":
        args[0] = args[0].transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises((ValueError, TypeError)):
        Splat()(*args)


@pytest.mark.parametrize("case", ["c1_shape", "coords_shape", "dtype", "coords_dtype",
                                  "mixed_dtype", "contiguity", "odd_size"])
def test_lookup_wrapper_rejects_bad_inputs(case):
    c0, c1, coords = _maps()
    if case == "c1_shape":
        c1 = c1[:, :-1]
    elif case == "coords_shape":
        coords = coords[:-1]
    elif case == "dtype":
        c0, c1 = c0.double(), c1.double()
    elif case == "coords_dtype":
        coords = coords.double()
    elif case == "mixed_dtype":
        c1 = c1.to(torch.bfloat16)
    elif case == "contiguity":
        c0 = c0.transpose(1, 2)
    elif case == "odd_size":
        c0 = torch.zeros(8, 15, 15)
    with pytest.raises((ValueError, TypeError)):
        CorrLookup()(c0, c1, coords)


class _Tiny(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.blocks = torch.nn.ModuleList([torch.nn.Conv2d(3, 4, 3)])
        self.norm = torch.nn.BatchNorm2d(4)
        self.head = torch.nn.Linear(4, 2)
        self.token = torch.nn.Parameter(torch.zeros(1, 2, 4))


def _tiny_variables(seed=0):
    rng = np.random.RandomState(seed)
    r = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    return {
        "params": {
            "blocks_0": {"kernel": r(3, 3, 3, 4), "bias": r(4)},
            "norm": {"scale": r(4), "bias": r(4)},
            "head": {"kernel": r(4, 2), "bias": r(2)},
            "token": r(1, 2, 4),
        },
        "batch_stats": {"norm": {"mean": r(4), "var": r(4) ** 2}},
    }


def test_load_jax_variables_maps_layouts():
    v = _tiny_variables()
    m = _Tiny()
    load_jax_variables(m, v)
    p = v["params"]
    np.testing.assert_array_equal(
        m.blocks[0].weight.detach().numpy(), p["blocks_0"]["kernel"].transpose(3, 2, 0, 1)
    )
    np.testing.assert_array_equal(m.head.weight.detach().numpy(), p["head"]["kernel"].T)
    np.testing.assert_array_equal(m.norm.weight.detach().numpy(), p["norm"]["scale"])
    np.testing.assert_array_equal(m.norm.running_var.numpy(), v["batch_stats"]["norm"]["var"])
    np.testing.assert_array_equal(m.token.detach().numpy(), p["token"])


def test_load_jax_variables_is_strict():
    v = _tiny_variables()
    del v["params"]["head"]["bias"]
    with pytest.raises(KeyError, match="head.bias"):
        load_jax_variables(_Tiny(), v)

    v = _tiny_variables()
    v["params"]["blocks_0"]["kernel"] = np.zeros((3, 3, 3, 5), np.float32)
    with pytest.raises(ValueError, match="shape mismatch"):
        load_jax_variables(_Tiny(), v)

    v = _tiny_variables()
    v["params"]["extra"] = {"kernel": np.zeros((1, 1), np.float32)}
    with pytest.raises(KeyError, match="not used"):
        load_jax_variables(_Tiny(), v)

    # modules the port does not build are skipped only when named
    v = _tiny_variables()
    v["params"]["bg_predictor"] = {"fc": {"kernel": np.zeros((2, 2), np.float32)}}
    v["params"]["vgg"] = {"conv": {"kernel": np.zeros((2, 2), np.float32)}}
    with pytest.raises(KeyError, match="not used"):
        load_jax_variables(_Tiny(), v)
    load_jax_variables(_Tiny(), v, skip=("bg_predictor", "vgg"))


def test_training_after_serving_in_one_process():
    """Constants cached while serving under inference mode (resize and blur
    matrices) stay usable by the training step's backward."""
    from tests.torch_parity import train_cfg

    torch.manual_seed(0)
    cfg = train_cfg(64, blocks=3, depth=1)
    model = MRFA(cfg, device="cpu")
    animator = Animator(model, model.state_dict(), device="cpu")
    frames = np.random.RandomState(0).rand(2, 64, 64, 3).astype(np.float32)
    animator.animate_frame(animator.begin(frames[0], frames[1]), frames[1])
    trainer = Trainer(cfg, device="cpu", weights=model.state_dict())
    assert np.isfinite(trainer.step({"source": frames, "driving": frames[::-1]})["loss"])
