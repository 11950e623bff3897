"""The vectorized NoC executor's torch array backend
(``repro_torch.core.noc.vectorized.set_array_backend("torch")``) without
the reference, so the card test can run where JAX is absent:

* it defaults to CUDA and raises where no GPU is present, leaving the
  numpy backend in effect (it never falls back to numpy on its own);
* on the card (``gpu``), ``chip_smoke.py``'s ``[noc]`` check: the batched
  window pass over a quick AlexNet mapper search's window keys, in int64
  and float64 tensors on the card, fills the window store bit for bit as
  the numpy backend and the heap engine do.

``tests/test_torch_executors.py`` holds the same pass under ``device=
"cpu"`` against the reference's.
"""
import importlib.util
from pathlib import Path

import pytest
import torch

from repro_torch.core.noc import vectorized as vec

ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def no_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the CUDA default is valid here")


def test_torch_backend_raises_without_a_card(no_gpu):
    for device in (None, "cuda", "cuda:0"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            vec.set_array_backend("torch", device=device)
        assert vec._STATE["backend"] == "numpy"
    assert vec.set_array_backend("torch", device="cpu") == "torch"
    assert vec._STATE["device"] == torch.device("cpu")
    assert vec.set_array_backend("numpy") == "numpy"
    assert vec._STATE["device"] is None


@pytest.mark.gpu
def test_torch_backend_on_the_card_matches_numpy_and_heap():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    doc = _chip_smoke().noc_torch_backend("cuda", "")
    assert doc["batched"] > 1 and doc["entries"] <= doc["keys"]
    assert vec._STATE["backend"] == "numpy"
