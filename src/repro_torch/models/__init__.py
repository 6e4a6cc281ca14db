"""Models of the port: GraphSAGE, the paper's training workload."""
from .gnn import GraphSAGE, GraphSAGEConfig, SageConfig, batch_to, sage_loss, sgd_step

__all__ = ["GraphSAGE", "GraphSAGEConfig", "SageConfig", "batch_to", "sage_loss", "sgd_step"]
