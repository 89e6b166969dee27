"""State capture and data of the port: estimator checkpoints, recordings
and flight-log replay."""
from omniswarm_torch.io.flightlog import (  # noqa: F401
    FlightLog,
    parse_flight_csv,
    replay_dataset,
    resample,
)
