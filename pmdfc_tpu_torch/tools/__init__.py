"""Harnesses and operator tools of the port (twins of the repo's `tools/`
where a drill or an operator needs one): `crashbox`, the child-process
SIGKILL harness; `multihost_worker`, one process of the multi-process
drill; `teletop`, `teledump` and `check_teledump`, the live console, the
snapshot pull and its schema check over the port's wire, none of which
needs JAX."""
