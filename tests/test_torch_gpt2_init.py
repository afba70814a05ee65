"""``gpt2_init`` draws its weights on the CPU whatever the device, so one
seed gives one set of weights on every device.

The CPU draw is pinned by a checksum of the state dict (names and bytes in
order), taken from the draw on a CPU generator that ``gpt2_init`` has
always made on the CPU.  On a card the ``cuda`` case asserts the moved
weights equal the CPU's bit for bit.  Needs torch only (no JAX), so the
card runs it with ``--noconftest``."""

import hashlib

import pytest

torch = pytest.importorskip("torch")

from loco_asr_tpu_torch.models.gpt2 import model as tg

CPU_SHA256 = {
    0: "d08d897708ef1f3632bd06e5c26b72721b21605567e7e55d7e8a1f3c81e68b18",
    5: "2b0b254fe4d445edc94d6dc6fc29381fe9a551c4ace86e47fb9c8f85f5f64237",
}


def _digest(model) -> str:
    h = hashlib.sha256()
    for name, t in model.state_dict().items():
        h.update(name.encode())
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("seed", sorted(CPU_SHA256))
def test_cpu_draw_is_pinned(seed):
    model = tg.gpt2_init(tg.tiny_gpt2_config(), seed=seed, device="cpu")
    assert _digest(model) == CPU_SHA256[seed]


@pytest.mark.cuda
@pytest.mark.parametrize("seed", sorted(CPU_SHA256))
def test_card_weights_equal_the_cpu_draw(seed):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = tg.tiny_gpt2_config()
    cpu = tg.gpt2_init(cfg, seed=seed, device="cpu").state_dict()
    card = tg.gpt2_init(cfg, seed=seed, device="cuda").state_dict()
    assert all(t.device.type == "cuda" for t in card.values())
    for name, want in cpu.items():
        torch.testing.assert_close(card[name].cpu(), want, rtol=0, atol=0)
    assert _digest(tg.gpt2_init(cfg, seed=seed, device="cuda")) == CPU_SHA256[seed]
