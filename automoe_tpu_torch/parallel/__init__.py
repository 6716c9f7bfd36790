"""Process groups and the whole-block parallel modes of the port (port of
automoe_tpu/parallel/): the mesh of processes (mesh.py), BatchNorm over
the data group (batchnorm.py), pipeline parallelism (pp.py), expert
parallelism (ep.py), tensor parallelism (tp.py) and spatial
partitioning with hand-written halos (sp.py)."""
from automoe_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    MeshSpec,
    active_mesh,
    choose_backend,
    init_world,
    make_mesh,
    pad_to_multiple,
)
from automoe_tpu_torch.parallel.pp import (  # noqa: F401
    pipeline_apply,
    stage_param_sharding,
)
from automoe_tpu_torch.parallel.tp import (  # noqa: F401
    tp_param_names,
    tp_shard_state,
)
