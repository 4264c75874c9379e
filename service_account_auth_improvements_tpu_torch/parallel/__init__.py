"""SPMD parallelism on ``torch.distributed`` (port of ``parallel/``): a
``DeviceMesh`` with dp/pp/fsdp/sp/tp/ep axes (``mesh.py``), bootstrap from
the controller-injected env (``multihost.py``), logical-axis sharding
rules resolved to DTensor placements and the per-rank region the model
computes in (``sharding.py``), differentiable collectives
(``collectives.py``), ring attention (``ring.py``) and Ulysses attention
(``ulysses.py``) for sequence parallelism, and the GPipe pipeline over
``pp`` (``pipeline.py``).
"""

from service_account_auth_improvements_tpu_torch.parallel.mesh import (  # noqa: F401
    MESH_AXES,
    MeshConfig,
    ambient_mesh,
    make_mesh,
    make_multislice_mesh,
    use_mesh,
)
from service_account_auth_improvements_tpu_torch.parallel.pipeline import (  # noqa: F401
    pipeline_layers,
    pipeline_stages,
)
from service_account_auth_improvements_tpu_torch.parallel.sharding import (  # noqa: F401
    DEFAULT_RULES,
    logical_to_mesh,
    logical_sharding,
    shard_constraint,
)
