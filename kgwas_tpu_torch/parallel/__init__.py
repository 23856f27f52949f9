"""Multi-device training over torch.distributed (the JAX package's
``kgwas_tpu/parallel``): ``mesh.py`` (process groups, the mesh, the
collectives), ``merged_shard.py`` (the merged GAT layer over the 'data'
axis), ``relation_shard.py`` (the per-relation and 'mp' layers over the
'data' axis), ``shard.py`` (the sharded train step and forward, the
'model' axis)."""
