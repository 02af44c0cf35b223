"""GNN message aggregation: out[v] = sum of msg[e] over edges e into v."""
