"""The plain reference that decides `correct`: the benchmarked
configurations in plain PyTorch, written from the published models, with
no kernel and nothing imported from the program (v2v_tpu_torch) or from
the JAX package. It takes the benchmark's weights and inputs and works
out again everything the program derives from them."""
