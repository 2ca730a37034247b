"""The port's CUDA kernel against its plain version, on the card.

These tests need an NVIDIA GPU and nvcc: they carry the ``cuda`` marker
and skip without a card. On a GPU machine run them with
``python -m pytest tests/test_torch_cuda.py -m cuda``.
"""

import numpy as np
import pytest

torch = pytest.importorskip('torch')

from cueball_tpu_torch.ops import fir  # noqa: E402
from cueball_tpu_torch.parallel import telemetry as tel  # noqa: E402
from cueball_tpu_torch.entry import example_inputs, tick_inputs  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')


@pytest.mark.parametrize('k', [128, 97, 1])
@pytest.mark.parametrize('p', [1, 255, 256, 300, 65536])
def test_fir_kernel_matches_plain(card, p, k):
    g = torch.Generator(device='cpu').manual_seed(p * 1000 + k)
    w = torch.rand((p, k), generator=g).mul_(8.0).to(card)
    taps = fir.gen_taps(k, device=card)
    before = fir.fir_apply_cuda.launches
    got = fir.fir_apply_cuda(w, taps)
    torch.cuda.synchronize()
    assert fir.fir_apply_cuda.launches == before + 1
    torch.testing.assert_close(got, fir.fir_apply_plain(w, taps),
                               rtol=1e-5, atol=1e-5)


def test_fir_kernel_rejects_bad_args(card):
    w = torch.ones((4, 8), device=card)
    with pytest.raises(TypeError):
        fir.fir_apply_cuda(w.double(), torch.ones(8, device=card).double())
    with pytest.raises(ValueError):
        fir.fir_apply_cuda(w, torch.ones(7, device=card))
    with pytest.raises(ValueError):
        fir.fir_apply_cuda(w.t(), torch.ones(4, device=card))


def test_fleet_step_on_card_uses_kernel(card):
    rng = np.random.default_rng(3)
    state, base = example_inputs(4096, seed=3, device=card)
    ref = state
    live = tel.make_live_step()
    before = fir.fir_apply_cuda.launches
    for k in range(4):
        inp = tick_inputs(base, rng, k)
        ref, r_out, _ = tel.fleet_step_plain(ref, inp)
        state, out, _ = live(state, inp)
        torch.testing.assert_close(out['filtered'], r_out['filtered'],
                                   rtol=1e-5, atol=1e-5)
        assert torch.equal(out['drop'], r_out['drop'])
        assert torch.equal(state.windows, ref.windows)
    assert fir.fir_apply_cuda.launches == before + 4
