from sypha.ops.linalg import chol_inverse, block_chol_inverse

__all__ = ["chol_inverse", "block_chol_inverse"]
