"""GF arithmetic, RapidRAID codes and the chain-pipeline scheduler."""
