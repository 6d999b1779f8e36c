"""Compat shim: ``from dicp_tpu_torch.ICP import ICP`` mirrors the
reference's ``from dICP.ICP import ICP`` import path."""

from dicp_tpu_torch.api import ICP, batch_size_handling  # noqa: F401
