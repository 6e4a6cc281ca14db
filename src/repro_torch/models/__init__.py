"""Models of the port: GraphSAGE, the paper's training workload, and the
TransformerLM that is served (dense, moe and mamba2 block patterns)."""
from .config import LMConfig, ModelConfig
from .gnn import GraphSAGE, GraphSAGEConfig, SageConfig, batch_to, sage_loss, sgd_step
from .model import TransformerLM, padded_vocab

__all__ = [
    "GraphSAGE", "GraphSAGEConfig", "LMConfig", "ModelConfig", "SageConfig",
    "TransformerLM", "batch_to", "padded_vocab", "sage_loss",
    "sgd_step",
]
