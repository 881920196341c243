from tputracer_torch.bsdf.bsdf import (  # noqa: F401
    emitted,
    eval_bsdf,
    nee_nonspecular,
    pdf_bsdf,
    sample_bsdf,
)
