"""The port stands alone: no module of ``src/repro_torch`` and not
``chip_smoke.py`` imports JAX or anything of the JAX package ``repro``
(the machine with the card has no JAX)."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.lineno, str(node.args[0].value).split(".")[0]


def test_port_files_exist():
    names = {p.relative_to(ROOT / "src").as_posix() for p in _port_files()
             if "src" in p.parts}
    for module in ("kernels/limb_matmul/ref.py", "kernels/blind/ref.py",
                   "core/prng.py", "configs/base.py", "kernels/build.py",
                   "kernels/blind/blind.py", "kernels/limb_matmul/ops.py",
                   "kernels/limb_matmul/limb_matmul.py",
                   "kernels/limb_matmul/fold.py", "core/blinding.py",
                   "core/sealing.py", "core/attestation.py",
                   "core/integrity.py", "models/layers.py", "models/vgg.py",
                   "core/slalom.py", "core/precompute.py", "core/plan.py",
                   "core/origami.py", "runtime/serving.py",
                   "runtime/faults.py",
                   "runtime/straggler.py", "runtime/devices.py",
                   "parallel/offload_sharding.py",
                   "configs/smollm_135m.py",
                   "kernels/flash_attention/ref.py",
                   "kernels/flash_attention/flash_attention.py",
                   "models/attention.py", "models/transformer.py",
                   "models/model.py", "runtime/sessions.py",
                   "runtime/generate.py", "core/tracing.py",
                   "core/trust.py", "core/planner.py",
                   "runtime/observability.py", "runtime/profiling.py",
                   "runtime/aot.py", "privacy/data.py", "privacy/ssim.py",
                   "runtime/engine.py", "runtime/chaos.py",
                   "launch/__init__.py", "launch/serve.py",
                   "optim/adamw.py", "privacy/cgan.py",
                   "privacy/reconstruct.py", "core/tree.py",
                   "models/moe.py", "configs/qwen3_moe_235b.py",
                   "configs/arctic_480b.py", "configs/yi_9b.py",
                   "configs/qwen2_5_14b.py", "configs/minicpm3_4b.py",
                   "models/ssm.py", "configs/zamba2_1_2b.py",
                   "configs/xlstm_1_3b.py",
                   "configs/llama3_2_vision_11b.py",
                   "configs/whisper_small.py", "data/pipeline.py",
                   "parallel/compression.py", "launch/steps.py",
                   "launch/train.py", "runtime/checkpoint.py",
                   "runtime/elastic.py", "launch/mesh.py", "launch/specs.py",
                   "launch/dryrun.py", "parallel/sharding.py",
                   "parallel/act_sharding.py", "parallel/hlo_analysis.py"):
        assert f"repro_torch/{module}" in names, module
    csrc = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
    for src in ("blind_encode.cu", "limb_matmul.cu", "limb_fold.cu",
                "blind.cu", "flash_attention.cu", "flash_attention_f32.cu",
                "flash_attention_bwd.cu"):
        assert (csrc / src).is_file(), src


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_or_reference_import(path):
    bad = [(line, root) for line, root in _imported_roots(path)
           if root in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"
