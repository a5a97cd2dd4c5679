"""PSF model families (port of semiblind_tv_tpu.models)."""
from semiblind_tv_tpu_torch.models.psf_models import (  # noqa: F401
    GaussianPsfModel,
    IsotropicGaussianPsfModel,
    LaplacePsfModel,
    MoffatPsfModel,
    ParamSpec,
    PsfModel,
)
