"""Full-size checks on an NVIDIA GPU (``gpu`` marker; see conftest.py).

Each preset's step on the card against the same jitted step on the CPU
backend, and the NumPy oracles at 128³ — the comparisons ``chip_smoke.py``
makes, one test each.
"""

import pytest

import chip_smoke

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("name", chip_smoke.PRESETS)
def test_preset_on_gpu_matches_cpu(gpus, name):
    chip_smoke.check_preset(name)


def test_oracles_at_128(gpus):
    chip_smoke.compare_oracle_3d(128)


def test_sharded512_on_four_gpus(gpus):
    if len(gpus) < 4:
        pytest.skip(f"needs 4 GPUs, found {len(gpus)}")
    chip_smoke.multi_phase(gpus[:4])
