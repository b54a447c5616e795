"""Harnesses and operator tools of the port (its own copies of the repo's
`tools/` where a drill or an operator needs one): `crashbox`, the
child-process SIGKILL harness; `multihost_worker`, one process of the
multi-process drill; `teletop`, `teledump` and `check_teledump`, the live
console, the snapshot pull and its schema rules over the port's wire;
`tracetool` and `proftool`, the cross-process span join and the
device-time breakdown over flight dumps. None of them needs JAX."""
