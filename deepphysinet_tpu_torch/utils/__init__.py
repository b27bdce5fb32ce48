"""Host helpers: path names, the async worker, field rendering, FLOP counts and profiling hooks."""
