"""AdamW with a warm-up cosine schedule, gradient accumulation and int8
gradient compression (the JAX package's ``optim``)."""
