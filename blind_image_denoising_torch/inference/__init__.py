"""Inference and model export / loading."""

from .denoiser import Denoiser
from .export import export_model, load_exported_model
