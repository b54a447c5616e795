"""Key conventions, the u32 word representation, and hashing."""
