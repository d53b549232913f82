"""Kernel wrappers, their plain versions, and the host table builders."""
