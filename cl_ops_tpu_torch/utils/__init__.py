"""Utilities: bit helpers, device selection and the kernel build."""
