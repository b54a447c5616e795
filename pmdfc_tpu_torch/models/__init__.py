"""Index structures (twin of `pmdfc_tpu/models`). Only the linear index
is ported so far; `base.get_index_ops` raises for the other families."""
