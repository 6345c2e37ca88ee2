"""The VAE stack: flow posteriors, ELBO losses and the IWAE likelihood."""

from umnn_tpu_torch.models.vae.iwae import calculate_likelihood
from umnn_tpu_torch.models.vae.losses import calculate_loss, calculate_loss_array
from umnn_tpu_torch.models.vae.vae import (
    IAFVAE,
    MMAVAE,
    VAE,
    VAE_FAMILIES,
    HouseholderSylvesterVAE,
    OrthogonalSylvesterVAE,
    PlanarVAE,
    TriangularSylvesterVAE,
)

__all__ = [
    "HouseholderSylvesterVAE",
    "IAFVAE",
    "MMAVAE",
    "OrthogonalSylvesterVAE",
    "PlanarVAE",
    "TriangularSylvesterVAE",
    "VAE",
    "VAE_FAMILIES",
    "calculate_likelihood",
    "calculate_loss",
    "calculate_loss_array",
]
