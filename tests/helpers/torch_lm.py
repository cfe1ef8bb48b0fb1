"""The small ``TransformerLM`` the port's serving tests share
(tests/test_torch_decode.py's): the JAX model from ``set_seed(1)`` and the
port's with its weights carried across, on the CPU; and the chi-squared
statistics of tests/test_sampling.py."""
import jax
import numpy as np

from bigdl_tpu.models.transformer import TransformerLM as JaxLM
from bigdl_tpu.utils.random import set_seed
from bigdl_tpu_torch.models import transformer as tt

VOCAB = 11
SEEDS = [[1, 2, 3], [4, 5], [6], [7, 8, 9, 10], [2, 4]]


def jax_lm(seed=1, vocab=VOCAB, n_layers=2):
    set_seed(seed)
    return JaxLM(vocab_size=vocab, d_model=16, n_heads=2, n_layers=n_layers,
                 hidden=32)


def port_of(lm, vocab=VOCAB, n_layers=2):
    m = tt.TransformerLM(vocab_size=vocab, d_model=16, n_heads=2,
                         n_layers=n_layers, hidden=32, device="cpu")
    return tt.load_jax_params(
        m, jax.tree_util.tree_map(np.asarray, lm.params())).evaluate()


def chi2_vs_expected(counts, probs):
    n = counts.sum()
    exp = n * np.asarray(probs, np.float64)
    mask = exp > 0
    return float(((counts[mask] - exp[mask]) ** 2 / exp[mask]).sum())


def chi2_two_sample(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    ka = np.sqrt(b.sum() / a.sum())
    kb = np.sqrt(a.sum() / b.sum())
    mask = (a + b) > 0
    return float((((ka * a - kb * b) ** 2)[mask] / (a + b)[mask]).sum())
