"""The port's command lines say what they support: no ``--help`` of a port
CLI describes a flag as not ported unless it is one of the
sequence-parallel flags that wait for ROADMAP A9 (``--mesh`` and
``--data_parallel`` are ported), the trainers' refusal names that item and
no JAX module (the GPU machine has no JAX), and the repository's root
``conftest.py`` builds the JAX package's native library once, on the
xdist controller only, going on when the build fails."""

import importlib
import importlib.util
import os
import re
import types

import pytest

pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLIS = ["decode_asr", "eval_ppl", "extract_embeddings", "fisher_prep", "loco_experiment",
        "slurp_sweep", "sph_decode", "train_asr", "train_classifier", "train_lm",
        "transcribe_episodes"]
# flags a --help may call not ported: sequence parallelism, ROADMAP A9
SEQUENCE_PARALLEL = {"--sequence_parallel", "--sp_impl", "--sp_devices", "--attn_impl"}
# the multi-device flags ported: (data, fsdp, tensor) mesh, data parallelism
PORTED = {"train_asr": "--mesh", "train_lm": "--mesh", "decode_asr": "--data_parallel",
          "extract_embeddings": "--data_parallel", "eval_ppl": "--data_parallel"}
UNPORTED = re.compile(r"not (yet )?ported|not supported|unported", re.I)


def _help(name: str, capsys) -> str:
    module = importlib.import_module(f"loco_asr_tpu_torch.pipelines.{name}")
    with pytest.raises(SystemExit) as e:
        module.main(["--help"])
    assert e.value.code == 0
    return capsys.readouterr().out


def _option_blocks(text: str):
    """(flags, description) of every option in an argparse help text."""
    blocks, current = [], None
    for line in text.splitlines():
        if re.match(r"^\s{1,4}-", line):
            current = [line]
            blocks.append(current)
        elif current is not None and line.startswith(" " * 6):
            current.append(line)
        else:
            current = None
    for block in blocks:
        head = re.split(r"\s{2,}", block[0].strip())[0]
        yield set(re.findall(r"--[\w-]+", head)), " ".join(" ".join(block).split())


@pytest.mark.parametrize("name", CLIS)
def test_help_calls_no_ported_flag_unported(name, capsys):
    text = _help(name, capsys)
    assert "--help" in text
    for flags, description in _option_blocks(text):
        if UNPORTED.search(description):
            assert flags & SEQUENCE_PARALLEL, (name, description)


def test_eval_ppl_help_describes_bfloat16_as_run(capsys):
    raw = _help("eval_ppl", capsys)
    text = " ".join(raw.split())
    assert "bfloat16 is not ported" not in text
    assert "bf16 forms" in text
    blocks = list(_option_blocks(raw))
    assert any("--sequence_parallel" in f and UNPORTED.search(d) for f, d in blocks)
    assert any("--data_parallel" in f and not UNPORTED.search(d) for f, d in blocks)
    assert any("--compute_dtype" in f and not UNPORTED.search(d) for f, d in blocks)


@pytest.mark.parametrize("flags", [{"mesh": "2,1,1", "attn_impl": "ulysses"},
                                   {"attn_impl": "ring"}, {"sp_devices": 2}])
def test_refusal_names_the_roadmap_item_and_no_jax_module(flags):
    from loco_asr_tpu_torch.pipelines import common

    args = types.SimpleNamespace(**{"mesh": "1,1,1", "attn_impl": "flash",
                                    "sp_devices": 0, **flags})
    with pytest.raises(SystemExit) as e:
        common.refuse_unported(args)
    message = str(e.value)
    assert message.startswith("not supported by this package yet")
    assert "sequence parallelism, ROADMAP A9" in message
    assert "loco_asr_tpu." not in message
    assert "--mesh" not in message


@pytest.mark.parametrize("name", sorted(PORTED))
def test_help_calls_the_ported_multi_device_flag_ported(name, capsys):
    """``--mesh`` of the trainers and ``--data_parallel`` of the inference
    pipelines run (ROADMAP A9a); no help calls them unported, and a
    trainer's mesh alone is not refused."""
    from loco_asr_tpu_torch.pipelines import common

    blocks = list(_option_blocks(_help(name, capsys)))
    flag = PORTED[name]
    assert any(flag in f and not UNPORTED.search(d) for f, d in blocks), name
    if flag == "--mesh":
        common.refuse_unported(types.SimpleNamespace(mesh="2,2,2", attn_impl="flash",
                                                     sp_devices=0))


def _root_conftest():
    spec = importlib.util.spec_from_file_location("root_conftest",
                                                  os.path.join(ROOT, "conftest.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_root_conftest_builds_the_jax_core_on_the_controller_only(monkeypatch):
    from loco_asr_tpu import native

    calls = []
    monkeypatch.setattr(native, "load", lambda: calls.append(1))
    conftest = _root_conftest()
    conftest.pytest_configure(types.SimpleNamespace(workerinput={"workerid": "gw0"}))
    assert calls == []
    conftest.pytest_configure(types.SimpleNamespace())
    assert calls == [1]


def test_root_conftest_goes_on_when_the_build_fails(monkeypatch):
    from loco_asr_tpu import native

    def fail():
        raise OSError("no compiler")

    monkeypatch.setattr(native, "load", fail)
    _root_conftest().pytest_configure(types.SimpleNamespace())
