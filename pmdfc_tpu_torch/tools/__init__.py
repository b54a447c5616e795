"""Harnesses of the port (twin of the repo's `tools/` where a drill needs
one): `crashbox`, the child-process SIGKILL harness, and
`multihost_worker`, one process of the multi-process drill."""
