/* ceres_tpu C API — C89 wrapper over the JAX solver.
 *
 * Capability parity with the reference's include/ceres/c_api.h:123-138:
 * create a problem, add residual blocks with C function-pointer costs and
 * (optional) robust losses, solve. Parameter memory is caller-owned; the
 * solve writes results back in place.
 *
 * Implementation: libceres_tpu_c.so embeds a CPython interpreter and
 * forwards to the ceres_tpu package (see capi/ceres_tpu_c.cpp). Link with
 * `python3-config --embed --ldflags`.
 */
#ifndef CERES_TPU_C_API_H_
#define CERES_TPU_C_API_H_

#ifdef __cplusplus
extern "C" {
#endif

/* Initialize the runtime (starts the embedded interpreter). Must be called
 * before anything else. Returns 0 on success. */
int ceres_init(void);

/* Cost: fill residuals (and jacobians[i], row-major num_residuals x
 * size_i, when the pointers are non-NULL). Return 1 on success, 0 on
 * failure (the solver treats the evaluation as invalid and retries with a
 * smaller trust region). */
typedef int (*ceres_cost_function_t)(void* user_data,
                                     double** parameters,
                                     double* residuals,
                                     double** jacobians);

/* Robust loss: write rho(s), rho'(s), rho''(s) into out[0..2]. */
typedef void (*ceres_loss_function_t)(void* user_data,
                                      double squared_norm,
                                      double out[3]);

/* Stock loss functions: create the callback data... */
void* ceres_create_huber_loss_function_data(double a);
void* ceres_create_softl1_loss_function_data(double a);
void* ceres_create_cauchy_loss_function_data(double a);
void* ceres_create_arctan_loss_function_data(double a);
void* ceres_create_tolerant_loss_function_data(double a, double b);
void ceres_free_stock_loss_function_data(void* loss_function_data);
/* ... and pass this as the loss_function with that data. */
void ceres_stock_loss_function(void* user_data, double squared_norm,
                               double out[3]);

typedef struct ceres_problem_s ceres_problem_t;
typedef struct ceres_residual_block_id_s ceres_residual_block_id_t;

ceres_problem_t* ceres_create_problem(void);
void ceres_free_problem(ceres_problem_t* problem);

ceres_residual_block_id_t* ceres_problem_add_residual_block(
    ceres_problem_t* problem,
    ceres_cost_function_t cost_function,
    void* cost_function_data,
    ceres_loss_function_t loss_function,
    void* loss_function_data,
    int num_residuals,
    int num_parameter_blocks,
    int* parameter_block_sizes,
    double** parameters);

void ceres_solve(ceres_problem_t* problem);

#ifdef __cplusplus
}
#endif
#endif /* CERES_TPU_C_API_H_ */
