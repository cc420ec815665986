"""Dense rank-k Cholesky up/down-dating, PyTorch port of ``repro.core``."""
from repro_torch.core.api import (  # noqa: F401
    chol_downdate,
    chol_downdate_batched,
    chol_update,
    chol_update_batched,
)
from repro_torch.core.blocked import chol_update_blocked  # noqa: F401
from repro_torch.core.factor import CholFactor  # noqa: F401
from repro_torch.core.precision import Precision  # noqa: F401
from repro_torch.core.ref import (  # noqa: F401
    chol_update_dense,
    chol_update_ref,
    modify_error,
)
from repro_torch.core.solve import (  # noqa: F401
    chol_logdet,
    chol_solve,
    downdate_feasible,
    is_positive_factor,
    solve_triangular,
)
