"""The port's ``train_classifier`` / ``slurp_sweep`` against the JAX
pipelines on the CPU, on a tiny seeded embedding store.

* One classifier step (``make_classifier_step``) against the JAX step from
  one shared init, for every pooling, masked and not, with both heads:
  loss and accuracy before the update, parameters after, within 1e-5.
* ``train_classifier`` for 2 epochs, both pipelines from one shared init
  (patched into each package's ``intent_classifier_init`` on the test
  side): per-epoch ``metrics.jsonl`` losses within 1e-5, accuracies equal,
  the same artifact files, the same parameters in them.
* ``slurp_sweep`` writes six ``ok`` entries equal to JAX's.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from loco_asr_tpu.models import intent as jintent
from loco_asr_tpu.parallel.train import reference_adam as jreference_adam
from loco_asr_tpu.pipelines import slurp_sweep as jsweep
from loco_asr_tpu.pipelines import train_classifier as jtrain
from loco_asr_tpu.utils.pytree import flatten_with_paths
from loco_asr_tpu_torch.data.embedding_store import EmbeddingShardWriter
from loco_asr_tpu_torch.models import intent as tintent
from loco_asr_tpu_torch.parallel.train import reference_adam
from loco_asr_tpu_torch.pipelines import slurp_sweep as tsweep
from loco_asr_tpu_torch.pipelines import train_classifier as ttrain

TOL = 1e-5
D, C = 16, 5
SPLITS = {"train": 21, "train_synthetic": 6, "devel": 9, "test": 7}


def _flat(params) -> dict:
    return {k: np.array(v) for k, v in flatten_with_paths(params).items()}


def _write_store(root, d, c) -> str:
    """extracted/speecht5/{split}/{audio,text} of seeded embeddings of 3-17
    frames of width ``d`` and one-hot targets of ``c`` classes; each class
    has its own mean frame, so the classifier has something to learn."""
    rng = np.random.default_rng(0)
    centres = rng.standard_normal((c, d)).astype(np.float32)
    for modality in ("audio", "text"):
        for split, n in SPLITS.items():
            w = EmbeddingShardWriter(str(root / "extracted/speecht5" / split / modality))
            for i in range(n):
                label = int(rng.integers(0, c))
                t = int(rng.integers(3, 18))
                emb = centres[label] + rng.standard_normal((t, d)).astype(np.float32)
                w.add(1000 * len(split) + i, emb, np.eye(c, dtype=np.float32)[label])
            w.close()
    return str(root / "extracted/speecht5")


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    return _write_store(tmp_path_factory.mktemp("emb"), D, C)


def _shared_init(hidden, d=D, c=C):
    params = jintent.intent_classifier_init(jax.random.PRNGKey(11), embedding_size=d,
                                            num_classes=c, hidden_dims=tuple(hidden))
    params["q"] = params["q"] * 1000.0
    return params


@pytest.mark.parametrize("hidden", [(), (8,)], ids=["linear", "mlp"])
@pytest.mark.parametrize("use_lengths", [True, False], ids=["masked", "parity"])
@pytest.mark.parametrize("method", tintent.POOLINGS)
def test_classifier_step_matches_jax(method, use_lengths, hidden):
    import optax

    params = _shared_init(hidden)
    model = tintent.intent_from_jax_params(_flat(params))
    rng = np.random.default_rng(3)
    emb = rng.standard_normal((6, 10, D)).astype(np.float32)
    lengths = np.array([10, 4, 7, 1, 9, 3], np.int32)
    targets = np.eye(C, dtype=np.float32)[rng.integers(0, C, 6)]

    tx_j = jreference_adam(1e-2, 1e-4)
    state_j = tx_j.init(params)
    tx_t = reference_adam(1e-2, 1e-4)
    state_t = tx_t.init(dict(model.named_parameters()))
    step = ttrain.make_classifier_step(method, use_lengths, tx_t)
    for _ in range(3):
        (jloss, jcorrect), grads = jax.value_and_grad(
            lambda p: jintent.intent_loss_and_acc(
                p, jnp.asarray(emb), jnp.asarray(targets), method=method,
                lengths=jnp.asarray(lengths) if use_lengths else None), has_aux=True)(params)
        updates, state_j = tx_j.update(grads, state_j, params)
        params = optax.apply_updates(params, updates)
        loss, correct = step(model, state_t, torch.from_numpy(emb), torch.from_numpy(lengths),
                             torch.from_numpy(targets))
        assert float(loss) == pytest.approx(float(jloss), abs=TOL, rel=TOL)
        assert float(correct) == float(jcorrect)
    want = _flat(params)
    got = tintent.intent_to_jax_params(model)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], atol=TOL, rtol=TOL, err_msg=key)


def _patch_shared_init(monkeypatch, hidden, d=D, c=C):
    params = _shared_init(hidden, d, c)
    monkeypatch.setattr(jintent, "intent_classifier_init", lambda *a, **kw: params)
    monkeypatch.setattr(tintent, "intent_classifier_init",
                        lambda *a, device=None, **kw:
                        tintent.intent_from_jax_params(_flat(params)).to(device))


def _metrics(root, pooling, modality="audio"):
    path = os.path.join(root, "results/fine_tuned", modality, pooling, "logs/metrics.jsonl")
    with open(path) as f:
        return [json.loads(line) for line in f]


def _artifacts(root):
    """Files under checkpoints/ and results/, a training-checkpointer step
    as its ``step_N`` name (orbax directories in JAX where orbax is
    installed, ``.npz`` files in the port)."""
    out = set()
    for base in ("checkpoints", "results"):
        for dirpath, _, files in os.walk(os.path.join(root, base)):
            for f in files:
                rel = os.path.relpath(os.path.join(dirpath, f), root)
                parts = rel.split(os.sep)
                step = next((p for p in parts if p.startswith("step_")), None)
                out.add(os.sep.join(parts[:parts.index(step)] + [step.split(".")[0]])
                        if step else rel)
    return out


@pytest.mark.parametrize("pooling,hidden,extra", [
    ("attention", (), []), ("max", (8,), []), ("average", (), ["--parity_pooling"])])
def test_train_classifier_matches_jax(store, tmp_path, monkeypatch, pooling, hidden, extra):
    _patch_shared_init(monkeypatch, hidden)
    argv = ["-m", "audio", "-p", pooling, "--folder", store, "--epochs", "2",
            "--batch_size", "4", "--print_every", "3", "--lr", "1e-2",
            "--embedding_size", str(D), "--num_classes", str(C), *extra]
    if hidden:
        argv += ["--hidden_dims", *map(str, hidden)]
    for name, main, more in (("jax", jtrain.main, []), ("port", ttrain.main, ["--device", "cpu"])):
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)
        assert main(argv + more) == 0
    want = _metrics(str(tmp_path / "jax"), pooling)
    got = _metrics(str(tmp_path / "port"), pooling)
    assert [m["epoch"] for m in got] == [m["epoch"] for m in want] == [1, 2]
    for g, w in zip(got, want):
        for key in ("train_loss", "val_loss"):
            assert g[key] == pytest.approx(w[key], abs=TOL, rel=TOL), key
        for key in ("train_acc", "val_acc"):
            assert g[key] == w[key], key
    files = _artifacts(str(tmp_path / "jax"))
    assert _artifacts(str(tmp_path / "port")) == files
    prefix = f"checkpoints/fine_tuned/audio/{pooling}/speecht5_{pooling}_audio_"
    assert {prefix + s for s in ("epoch_1.npz", "epoch_2.npz", "best.npz", "last.npz")} <= files
    for name in ("best", "last"):
        with np.load(tmp_path / "jax" / (prefix + f"{name}.npz")) as a, \
                np.load(tmp_path / "port" / (prefix + f"{name}.npz")) as b:
            assert set(a.files) == set(b.files)
            for k in a.files:
                np.testing.assert_allclose(b[k], a[k], atol=TOL, rtol=TOL, err_msg=k)
    with open(tmp_path / "port/results/fine_tuned/audio" / pooling / "logs/results.txt") as f:
        lines = f.read().splitlines()
    with open(tmp_path / "jax/results/fine_tuned/audio" / pooling / "logs/results.txt") as f:
        assert len(lines) == len(f.read().splitlines())
    assert lines[0] == "Results" and lines[1].startswith("Epoch [1/2], Iteration [3/")


def test_slurp_sweep_matches_jax(tmp_path, monkeypatch):
    """At the default widths (768, 101 classes): the sweep's ``--extra``
    cannot carry dashed flags through argparse."""
    store = _write_store(tmp_path / "store", 768, 101)
    argv = ["--folder", store, "--epochs", "2", "--batch_size", "8"]
    _patch_shared_init(monkeypatch, (), 768, 101)
    out = {}
    for name, main, more in (("jax", jsweep.main, []), ("port", tsweep.main, ["--device", "cpu"])):
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)
        assert main(more + argv) == 0
        with open(tmp_path / name / "results/fine_tuned/sweep.json") as f:
            out[name] = json.load(f)
    assert len(out["port"]) == 6
    assert all(r["status"] == "ok" for r in out["port"].values())
    assert out["port"] == out["jax"]


def test_train_classifier_needs_a_gpu_unless_asked_for_cpu(store, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttrain.main(["-m", "audio", "-p", "average", "--folder", store])
