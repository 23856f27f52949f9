from .mlp import SimpleMLP
from .convs import (GATConv, GCNConv, SAGEConv, SGConv, gat_relation,
                    gcn_relation, sage_relation, sgc_relation)
from .hetero_gnn import (
    GO_TYPES,
    DeviceLayout,
    HeteroConv,
    HeteroGNN,
    aggregate,
    check_supported,
    device_layouts,
    encoder_for,
    layer_path,
    layer_paths,
)
