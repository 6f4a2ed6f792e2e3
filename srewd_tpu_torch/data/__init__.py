"""WeatherBench data layer (the port's copy of srewd_tpu.data): npy store,
date indexing, month-grouped scalers and the batching DataHandler."""
