from semi_pd_tpu_torch.constrained.grammar import GrammarCompiler, GrammarMatcher

__all__ = ["GrammarCompiler", "GrammarMatcher"]
