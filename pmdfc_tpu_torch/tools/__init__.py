"""Harnesses of the port (twin of the repo's `tools/` where a drill needs
one): `crashbox`, the child-process SIGKILL harness."""
