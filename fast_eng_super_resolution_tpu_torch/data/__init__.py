"""Host data layer: mesh readers/writers, partitioner, datasets, reconstruction.

``reconstruct`` is not imported here: its device half needs torch, and the
host ETL should import without it.
"""

from .dataset import AnsysDataset, DuctAnalysisDataset, SyntheticDataset, init_dataset
from .fluent_cff import read_cas_h5, write_cas_h5
from .fluent_msh import read_msh, write_msh
from .partition import extract_subdomains, uniform_box_subdomains
from .vtu import read_vtu, write_vtu

__all__ = ["AnsysDataset", "DuctAnalysisDataset", "SyntheticDataset",
           "init_dataset", "read_cas_h5", "write_cas_h5", "read_msh",
           "write_msh", "extract_subdomains", "uniform_box_subdomains",
           "read_vtu", "write_vtu"]
