"""Parity of the port's zoo graphs with the reference's live import at the
default sequence length (``DEFAULT_SEQ`` 256), for every registry config's
layer and training-step unit: the bars of ``test_torch_model_zoo.py``'s
seq-64 cases (``assert_parity``)."""
import pytest

from repro.configs.registry import ARCH_IDS
from repro_torch.graphs.model_zoo import DEFAULT_SEQ
from test_torch_model_zoo import assert_parity


@pytest.mark.parametrize("which", ["layer", "unit"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_zoo_parity_default_seq(arch, which):
    assert DEFAULT_SEQ == 256
    assert_parity(arch, which, DEFAULT_SEQ)
