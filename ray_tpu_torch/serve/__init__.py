"""Serving: the paged LLM engine (``serve.llm_engine``)."""
