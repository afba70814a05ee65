"""The port's prefetch iterator against the JAX package's (order, how far
the producer runs ahead, exceptions), and ``train_asr``'s batch stream
through it: the batches that reach the steps are the dataset's own, in
its order, read 4 ahead."""

import json
import time

import numpy as np
import pytest

pytest.importorskip("torch")

from loco_asr_tpu.utils import prefetch as jpf
from loco_asr_tpu_torch.utils import prefetch as tpf
from tests.test_torch_remat import _relocated_dev


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_order_matches_jax(depth):
    items = [{"i": i, "x": np.full(3, i)} for i in range(37)]
    got = list(tpf.prefetch(iter(items), depth=depth))
    want = list(jpf.prefetch(iter(items), depth=depth))
    assert [g["i"] for g in got] == [w["i"] for w in want] == list(range(37))
    assert all(g is it for g, it in zip(got, items))


@pytest.mark.parametrize("depth", [1, 3])
def test_producer_runs_depth_ahead_as_jax(depth):
    """Unconsumed, each producer fills its buffer and holds one more item
    at its blocked put; a consumed item lets exactly one more through."""
    runs = {}
    for tag, mod in (("jax", jpf), ("port", tpf)):
        produced = []

        def source():
            for i in range(20):
                produced.append(i)
                yield i

        it = mod.prefetch(source(), depth=depth)
        deadline = time.time() + 10.0
        while len(produced) < depth + 1 and time.time() < deadline:
            time.sleep(0.01)
        time.sleep(0.1)
        first = len(produced)
        assert next(it) == 0
        deadline = time.time() + 10.0
        while len(produced) < first + 1 and time.time() < deadline:
            time.sleep(0.01)
        time.sleep(0.1)
        runs[tag] = (first, len(produced), list(it))
    assert runs["port"] == runs["jax"]
    assert runs["port"][:2] == (depth + 1, depth + 2)
    assert runs["port"][2] == list(range(1, 20))


def test_exception_reraises_after_the_items_before_it_as_jax():
    def bad():
        yield 1
        yield 2
        raise KeyError("boom")

    for mod in (jpf, tpf):
        it = mod.prefetch(bad(), depth=4)
        assert [next(it), next(it)] == [1, 2]
        with pytest.raises(KeyError, match="boom"):
            next(it)
    it = tpf.prefetch(iter([]))
    with pytest.raises(StopIteration):
        next(it)


def test_train_asr_reads_the_dataset_batches_through_prefetch(tmp_path, monkeypatch):
    from loco_asr_tpu_torch.data.asr_dataset import KaldiAsrDataset
    from loco_asr_tpu_torch.data.tokenizer import load_tokenizer
    from loco_asr_tpu_torch.pipelines import train_asr

    dev_dir = _relocated_dev(tmp_path)
    seen, depths = [], []
    real = tpf.prefetch

    def recording(source, depth=2):
        depths.append(depth)
        for item in real(source, depth):
            seen.append(item)
            yield item

    monkeypatch.setattr(tpf, "prefetch", recording)
    conv = tmp_path / "conv.json"
    conv.write_text(json.dumps(dict(conv_dim=[16] * 7, conv_stride=[5, 2, 2, 2, 2, 2, 2],
                                    conv_kernel=[10, 3, 3, 3, 3, 2, 2])))
    steps, batch, seed = 4, 4, 3
    assert train_asr.main(["--train_dir", dev_dir, "--out_dir", str(tmp_path / "run"), "--tiny",
                           "--config_json", str(conv), "--device", "cpu", "--steps", str(steps),
                           "--batch_size", str(batch), "--max_seconds", "1", "--seed", str(seed),
                           "--save_every", "100", "--eval_every", "100"]) == 0
    assert depths == [4] and len(seen) >= steps
    tok = load_tokenizer("char")
    tok.vocab_size = 256
    want = KaldiAsrDataset(dev_dir).batches(tok, batch, max_seconds=1.0, max_label_len=128,
                                            shuffle=True, seed=seed, eos_id=2)
    for got, ref in zip(seen, want):
        assert got["utt_ids"] == ref["utt_ids"]
        for key in ("input_values", "attention_mask", "labels"):
            np.testing.assert_array_equal(got[key], ref[key])
