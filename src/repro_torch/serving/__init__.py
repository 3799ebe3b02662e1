"""Serving: the bucketed solve-as-a-service loop (`serving.solve_service`
over `serving.bucket_cache`), the reference's `repro.serving` solve
service on the port's captured block solves; and the LM engine
(`serving.engine`), continuous batching over fixed decode slots."""
