from posetraj_torch.data.trajectories import load_cotracker_json, trajectories_to_array  # noqa: F401
from posetraj_torch.data.datasets import TrajectoryBlenderDataset, TrajectoryVIPSegDataset  # noqa: F401
from posetraj_torch.data import export  # noqa: F401
