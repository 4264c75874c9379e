"""Import discipline of the port: no module of it, nor chip_smoke.py or
kernel_variants.py, imports ``jax`` or the JAX package; its entry points
refuse to run without CUDA unless asked for the CPU."""

import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = "service_account_auth_improvements_tpu_torch"

# A meta-path finder that refuses jax and the JAX package. Python 3.12
# calls only find_spec (never find_module). The JAX package's name is a
# prefix of the port's, so it is matched exactly, not by prefix.
BLOCKER = textwrap.dedent("""
    import importlib, pathlib, sys

    class Blocker:
        def find_spec(self, name, path=None, target=None):
            if (name == "jax" or name.startswith("jax.")
                    or name == "jaxlib" or name.startswith("jaxlib.")
                    or name == "service_account_auth_improvements_tpu"
                    or name.startswith(
                        "service_account_auth_improvements_tpu.")):
                raise ImportError(f"blocked import of {name}")
            return None

    for mod in [m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib")]:
        del sys.modules[mod]
    sys.meta_path.insert(0, Blocker())
    repo = pathlib.Path(sys.argv[1])
    sys.path.insert(0, str(repo))
    names = sorted(
        ".".join(p.relative_to(repo).with_suffix("").parts)
        for p in (repo / "%s").rglob("*.py"))
    for name in names:
        importlib.import_module(name.removesuffix(".__init__"))
    importlib.import_module("chip_smoke")
    importlib.import_module("kernel_variants")
    leaked = [m for m in sys.modules if m.split(".")[0] in
              ("jax", "jaxlib", "service_account_auth_improvements_tpu")]
    assert not leaked, leaked
    print("imported", len(names) + 2)
""" % PORT)


def test_port_and_chip_smoke_import_without_jax():
    out = subprocess.run([sys.executable, "-c", BLOCKER, str(REPO)],
                         capture_output=True, text=True, timeout=120,
                         cwd=REPO)
    assert out.returncode == 0, out.stderr
    n = len(list((REPO / PORT).rglob("*.py"))) + 2
    assert out.stdout.strip() == f"imported {n}"


# the lifecycle slice's modules and the modules that hold the MoE FFN and
# its decode path, each imported alone under the blocker
LIFECYCLE = ["train.checkpoint", "train.evaluate", "models.quantize",
             "models.speculative"]
MOE = ["models.llama", "models.generate"]
# the fine-tuning and side-model slice's modules
FINETUNE = ["train.lora", "train.distill", "models.convert_hf",
            "models.resnet", "models.mnist"]
# the parallel slice's modules, and the module the multi-rank tests spawn
# their rank processes from (which must run without JAX)
PARALLEL = ["parallel", "parallel.mesh", "parallel.multihost",
            "parallel.sharding", "parallel.collectives", "parallel.ring",
            "parallel.ulysses", "parallel.pipeline"]
WORKERS = "tests.torch_parallel_workers"
# the policy trainer and the accelerator binding
CONTROLPLANE = ["controlplane", "controlplane.gpu", "controlplane.scheduler",
                "controlplane.scheduler.policy",
                "controlplane.scheduler.policy.features",
                "controlplane.scheduler.policy.model",
                "controlplane.scheduler.policy.train"]


@pytest.mark.parametrize("module", LIFECYCLE + MOE + FINETUNE + PARALLEL
                         + CONTROLPLANE + [WORKERS])
def test_lifecycle_module_imports_without_jax(module):
    full = module if module == WORKERS else PORT + "." + module
    probe = BLOCKER.replace(
        "for name in names:\n"
        "    importlib.import_module(name.removesuffix(\".__init__\"))\n",
        f"names = [{full!r}]\n"
        "importlib.import_module(names[0])\n")
    assert probe != BLOCKER
    out = subprocess.run([sys.executable, "-c", probe, str(REPO)],
                         capture_output=True, text=True, timeout=120,
                         cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "imported 3"


def test_blocker_blocks():
    """The finder really refuses the JAX package (and not the port)."""
    probe = BLOCKER.replace('importlib.import_module("chip_smoke")',
                            'importlib.import_module('
                            '"service_account_auth_improvements_tpu.ops")')
    out = subprocess.run([sys.executable, "-c", probe, str(REPO)],
                         capture_output=True, text=True, timeout=120,
                         cwd=REPO)
    assert out.returncode != 0
    assert "blocked import of service_account_auth_improvements_tpu" \
        in out.stderr


def test_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    from service_account_auth_improvements_tpu_torch.models import (
        convert_hf,
        generate,
        llama,
        mnist,
        resnet,
        serving,
        speculative,
    )
    from service_account_auth_improvements_tpu_torch.train import (
        checkpoint,
        data,
        evaluate,
        lora,
        loop,
        step,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = llama.PRESETS["tiny"]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        llama.init(cfg, torch.Generator())
    params = llama.init(cfg, torch.Generator(), device="cpu")
    toks = torch.zeros(1, 4, dtype=torch.long)
    ck = tmp_path / "ck"
    checkpoint.save(ck, step.init_train_state(cfg, torch.Generator(),
                                              device="cpu"))
    for call in (
        lambda: generate.prefill(cfg, params, toks, 8),
        lambda: generate.prefill_chunked(cfg, params, toks, 8, window=4),
        lambda: generate.generate(cfg, params, toks, 2),
        lambda: generate.start_stream(cfg, params, toks, 2),
        lambda: serving.GenerationService(cfg, params),
        lambda: serving.main(["--preset", "tiny", "--port", "0"]),
        lambda: step.init_train_state(cfg, torch.Generator()),
        lambda: data.TokenBatches(np.zeros(64, np.int32),
                                  data.DataConfig(batch=1, seq=8)),
        lambda: loop.fit(cfg, None, np.zeros(64, np.int32),
                         data.DataConfig(batch=1, seq=8),
                         loop.LoopConfig(steps=1)),
        lambda: loop.main(["--preset", "tiny", "--steps", "1"]),
        lambda: checkpoint.restore_params(ck, None, cfg),
        lambda: evaluate.evaluate(cfg, params, [toks]),
        lambda: speculative.spec_generate(cfg, params, cfg, params, toks, 2),
        lambda: serving.main(["--preset", "tiny", "--port", "0",
                              "--checkpoint-dir", str(ck), "--int8"]),
        # a sharded server checks the card before it starts a mesh
        lambda: serving.main(["--preset", "tiny", "--port", "0",
                              "--tp", "2"]),
        lambda: lora.init_lora(cfg, lora.LoraConfig(), torch.Generator()),
        lambda: lora.init_lora_state(cfg, lora.LoraConfig(),
                                     torch.Generator()),
        lambda: loop.fit(cfg, None, np.zeros(64, np.int32),
                         data.DataConfig(batch=1, seq=8),
                         loop.LoopConfig(steps=1), lora=lora.LoraConfig(),
                         base_params=params),
        lambda: convert_hf.params_from_hf_state_dict(
            cfg, convert_hf.to_hf_state_dict(cfg, params)),
        lambda: mnist.init(mnist.MnistConfig(), torch.Generator()),
        lambda: resnet.init(resnet.PRESETS["resnet18-smoke"],
                            torch.Generator()),
    ):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    state, _ = generate.start_stream(cfg, params, toks, 2, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        generate.stream_decode(cfg, params, state, 1)
