"""Models of the port: GraphSAGE, the paper's training workload, and the
TransformerLM that is trained and served (all six block patterns of the
reference: dense, gemma2, moe, mamba2, zamba2 and the encoder; both
frontends)."""
from .config import LMConfig, ModelConfig
from .gnn import GraphSAGE, GraphSAGEConfig, SageConfig, batch_to, sage_loss, sgd_step
from .model import TransformerLM, padded_vocab

__all__ = [
    "GraphSAGE", "GraphSAGEConfig", "LMConfig", "ModelConfig", "SageConfig",
    "TransformerLM", "batch_to", "padded_vocab", "sage_loss",
    "sgd_step",
]
