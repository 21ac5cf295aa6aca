"""PAM core: partial-attention algebra, tiers, importance, Alg. 2, layouts."""
