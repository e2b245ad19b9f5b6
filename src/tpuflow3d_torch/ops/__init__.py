from tpuflow3d_torch.ops.registry import OPS, OpSpec, get_op

__all__ = ["OPS", "OpSpec", "get_op"]
