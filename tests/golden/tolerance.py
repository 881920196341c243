"""The golden image tolerances of tests/golden/test_pt_vs_oracle.py, in a
module that imports no JAX: the card's tests, which run where the JAX
package cannot, hold images to them too."""

import numpy as np


def golden_compare(img, ref):
    """Mean relative error < 5e-4, outlier share (rel > 5e-3) < 1%, and
    an image that is not black."""
    err = np.abs(img - ref)
    rel = err / (1.0 + np.abs(ref))
    frac_bad = float((rel > 5e-3).mean())
    assert float(rel.mean()) < 5e-4, f"mean rel err {rel.mean():.2e}"
    assert frac_bad < 0.01, f"outlier fraction {frac_bad:.3f}"
    assert img.mean() > 1e-3
