"""Validator signing (SURVEY.md layer 8, reference privval/ ~1.7k LoC):
file-backed signer with double-sign protection + remote signer protocol."""

from .file_pv import FilePV  # noqa: F401
